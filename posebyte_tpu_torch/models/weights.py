"""Weight loading for the port: a numpy-only safetensors reader and writer,
the JAX parameter layout turned into PyTorch's, and the raw-ingest stem
fold.

Parameters are a flat dict {key: np.ndarray} whose keys are the flattened
pytree paths the JAX package writes (posebyte_tpu/models/weights.py:274-328):
"b0.w", "b2.cv1.b", "b2.m.0.cv1.w", "head.cv2.0.2.w", ... Conv weights are
OIHW (PyTorch's conv2d layout); the JAX package stores HWIO. BatchNorm is
already fused into every conv.
"""
from __future__ import annotations

import json
import struct

import numpy as np

_ST_DTYPES = {"F32": np.float32, "F64": np.float64, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str):
    """Read a safetensors file -> ({name: np.ndarray}, metadata dict).

    Format: an 8-byte little-endian header length, a JSON header mapping
    each tensor name to {dtype, shape, data_offsets} (offsets into the data
    that follows the header), and "__metadata__" (str -> str)."""
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", blob[:8])
    if 8 + n > len(blob):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(blob[8:8 + n].decode("utf-8"))
    meta = header.pop("__metadata__", None) or {}
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, info in header.items():
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path}: tensor {name!r} lies outside the data")
        arr = np.frombuffer(data[begin:end], dtype=dtype)
        if arr.size != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: tensor {name!r} size does not match "
                             f"its shape {shape}")
        out[name] = arr.reshape(shape).copy()
    return out, meta


def write_safetensors(path: str, tensors: dict, metadata: dict | None = None):
    """Write {name: np.ndarray} (and str -> str metadata) as a safetensors
    file that read_safetensors and the safetensors package both read: the
    header (its JSON padded with spaces to a multiple of 8 bytes), then
    each tensor's little-endian bytes in the dict's order, contiguous."""
    names = {np.dtype(v): k for k, v in _ST_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name, arr in tensors.items():
        arr = np.asarray(arr, order="C")          # keeps 0-d arrays
        if arr.dtype not in names:
            raise ValueError(f"{name!r}: unsupported dtype {arr.dtype}")
        data = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": names[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for data in blobs:
            f.write(data)


def _to_torch_layout(flat: dict) -> dict:
    """HWIO conv weights -> OIHW. Quantised weights stay int8 (the
    per-channel "scale" and the activation's "act_scale", 0-d, are
    float32 like every other tensor)."""
    out = {}
    for k, v in flat.items():
        v = np.asarray(v)
        if not (k.endswith(".w") and v.dtype == np.int8):
            v = v.astype(np.float32)
        if v.ndim == 4:
            v = np.ascontiguousarray(np.transpose(v, (3, 2, 0, 1)))
        out[k] = v
    return out


def load_params(path: str, name: str | None = None):
    """Load a checkpoint saved by the JAX package (float, or int8 from
    models.quant) -> (params, model name).

    params is the port's flat dict (OIHW conv weights, numpy)."""
    flat, meta = read_safetensors(path)
    name = name or meta.get("model")
    if name is None:
        raise ValueError(f"{path}: no model name in the metadata; pass name=")
    return _to_torch_layout(flat), name


def save_params(params: dict, path: str, name: str):
    """Write the port's flat dict as the JAX package's checkpoint
    (posebyte_tpu/models/weights.py::save_params): HWIO conv weights, the
    same keys and metadata, so either package loads it."""
    flat = {}
    for k, v in params.items():
        v = np.asarray(v)
        flat[k] = np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0))) \
            if v.ndim == 4 else v
    write_safetensors(path, flat, {"model": name,
                                   "format": "posebyte-tpu-v1"})


def params_from_jax(tree) -> dict:
    """The JAX package's parameter pytree (nested dicts/lists of arrays,
    HWIO convs, BN fused; its static metadata leaves are skipped) -> the
    port's flat dict, with the key naming of the safetensors files."""
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        elif hasattr(node, "shape"):
            flat[prefix[:-1]] = np.asarray(node)

    walk(tree, "")
    return _to_torch_layout(flat)


def fold_stem_preprocess(params: dict) -> dict:
    """Fold BGR->RGB and /255 into the stem conv (after
    posebyte_tpu/models/weights.py:331-360).

    The stem's input-channel axis is reversed and its weights scaled by
    float32(1/255), so conv(w_folded, raw_bgr_0_255) equals
    conv(w, rgb_normalized) exactly in float32 (the conv is linear in its
    input; the bias is untouched). Pairs with the raw letterbox
    (ops.preprocess.letterbox_flat_nhwc)."""
    out = dict(params)
    w = np.asarray(params["b0.w"], np.float32)            # [O, 3, kh, kw]
    out["b0.w"] = np.ascontiguousarray(w[:, ::-1]) * np.float32(1.0 / 255.0)
    return out

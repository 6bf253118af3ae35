"""Weight loading for the port: a numpy-only safetensors reader and writer,
the JAX parameter layout turned into PyTorch's, the Ultralytics `.pt`
import (after posebyte_tpu/models/weights.py:40-271: read without the
ultralytics package, every BatchNorm folded into its conv) and the
raw-ingest stem fold.

Parameters are a flat dict {key: np.ndarray} whose keys are the flattened
pytree paths the JAX package writes (posebyte_tpu/models/weights.py:274-328):
"b0.w", "b2.cv1.b", "b2.m.0.cv1.w", "head.cv2.0.2.w", ... Conv weights are
OIHW (PyTorch's conv2d layout); the JAX package stores HWIO. BatchNorm is
already fused into every conv.
"""
from __future__ import annotations

import importlib
import io
import json
import pickle
import struct

import numpy as np

from .yolo_pose import MODEL_CONFIGS

BN_EPS = 1e-3   # ultralytics Conv uses BatchNorm2d(eps=0.001)

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


# ---------------------------------------------------------------------------
# Ultralytics .pt checkpoints, read without the ultralytics package
# ---------------------------------------------------------------------------

class _Stub:
    """Stand-in for any class of the pickle that is not torch's, numpy's,
    collections' or a builtin (the ultralytics model classes)."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __call__(self, *args, **kwargs):   # some reduces call the object
        return self


def _make_unpickler_module():
    """A pickle module for torch.load whose unpickler resolves torch,
    collections, numpy and builtins classes and stubs every other."""

    class StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] in ("torch", "collections", "numpy",
                                        "builtins", "__builtin__"):
                try:
                    return getattr(importlib.import_module(module), name)
                except (ImportError, AttributeError):
                    pass
            return type(name, (_Stub,), {"__module__": module})

    class Shim:
        Unpickler = StubUnpickler

        @staticmethod
        def load(f, **kw):
            return StubUnpickler(f).load()

        @staticmethod
        def loads(b, **kw):
            return StubUnpickler(io.BytesIO(b)).load()

    return Shim


def _walk_module(obj, prefix: str, out: dict):
    """Collect the tensors of a stubbed nn.Module tree (its _parameters
    and _buffers, then its _modules) as float32 numpy under dotted
    names."""
    d = getattr(obj, "__dict__", None)
    if d is None:
        return
    for bag_name in ("_parameters", "_buffers"):
        for k, v in (d.get(bag_name) or {}).items():
            if v is None:
                continue
            arr = np.asarray(v.detach().to("cpu").float().numpy()
                             if hasattr(v, "detach") else v)
            out[f"{prefix}{k}"] = arr.astype(np.float32)
    for k, child in (d.get("_modules") or {}).items():
        _walk_module(child, f"{prefix}{k}.", out)


def load_ultralytics_checkpoint(path: str) -> dict:
    """Read an Ultralytics YOLO .pt checkpoint -> {name: float32 numpy}
    with names like "model.0.conv.weight". A training checkpoint holds
    "ema" beside "model": the EMA weights are the deployable ones and win
    (a released .pt holds them under "model")."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_make_unpickler_module())
    if isinstance(ckpt, dict):
        model = ckpt.get("ema") or ckpt.get("model") or ckpt
    else:
        model = ckpt
    if not hasattr(model, "__dict__"):
        raise ValueError(f"unrecognized checkpoint structure in {path}")
    out: dict = {}
    _walk_module(model, "", out)
    if not out:
        raise ValueError(f"no tensors found in {path}")
    return out


def _fused_conv(sd: dict, prefix: str, out: dict, key: str):
    """An ultralytics Conv (conv + BatchNorm) -> out[key + ".w"] (OIHW)
    and out[key + ".b"], the BatchNorm folded with the JAX package's numpy
    arithmetic: s = g / sqrt(var + BN_EPS), w * s, beta - mean * s."""
    w = sd[f"{prefix}.conv.weight"]
    if f"{prefix}.bn.weight" in sd:
        g = sd[f"{prefix}.bn.weight"]
        beta = sd[f"{prefix}.bn.bias"]
        mean = sd[f"{prefix}.bn.running_mean"]
        var = sd[f"{prefix}.bn.running_var"]
        scale = g / np.sqrt(var + BN_EPS)
        w = w * scale[:, None, None, None]
        b = beta - mean * scale
    else:
        b = sd.get(f"{prefix}.conv.bias", np.zeros(w.shape[0], np.float32))
    out[key + ".w"] = np.ascontiguousarray(w, np.float32)
    out[key + ".b"] = np.asarray(b, np.float32)


def _plain_conv(sd: dict, prefix: str, out: dict, key: str):
    """An nn.Conv2d with bias (the heads' output convs)."""
    w = sd[f"{prefix}.weight"]
    b = sd.get(f"{prefix}.bias", np.zeros(w.shape[0], np.float32))
    out[key + ".w"] = np.ascontiguousarray(w, np.float32)
    out[key + ".b"] = np.asarray(b, np.float32)


def _fill_cv1_cv2(sd, prefix, out, key):
    """A block's cv1 and cv2 (a bottleneck's two convs, SPPF's, the outer
    convs of C2f, C3, C3k2 and C2PSA)."""
    _fused_conv(sd, f"{prefix}.cv1", out, f"{key}.cv1")
    _fused_conv(sd, f"{prefix}.cv2", out, f"{key}.cv2")


def _fill_c2f(sd, prefix, out, key, n):
    _fill_cv1_cv2(sd, prefix, out, key)
    for i in range(n):
        _fill_cv1_cv2(sd, f"{prefix}.m.{i}", out, f"{key}.m.{i}")


def _fill_c3(sd, prefix, out, key, n):
    _fill_cv1_cv2(sd, prefix, out, key)
    _fused_conv(sd, f"{prefix}.cv3", out, f"{key}.cv3")
    for i in range(n):
        _fill_cv1_cv2(sd, f"{prefix}.m.{i}", out, f"{key}.m.{i}")


def _fill_c3k2(sd, prefix, out, key, n, c3k):
    """C3k2: inner block i, a C3k of 2 bottlenecks or a bottleneck, under
    the key "m.{i}.1" (the JAX tree's (kind, params) tuple)."""
    _fill_cv1_cv2(sd, prefix, out, key)
    for i in range(n):
        if c3k:
            _fill_c3(sd, f"{prefix}.m.{i}", out, f"{key}.m.{i}.1", 2)
        else:
            _fill_cv1_cv2(sd, f"{prefix}.m.{i}", out, f"{key}.m.{i}.1")


def _fill_c2psa(sd, prefix, out, key, n):
    _fill_cv1_cv2(sd, prefix, out, key)
    for i in range(n):
        mp, mk = f"{prefix}.m.{i}", f"{key}.m.{i}"
        for name in ("qkv", "proj", "pe"):
            _fused_conv(sd, f"{mp}.attn.{name}", out, f"{mk}.attn.{name}")
        _fused_conv(sd, f"{mp}.ffn.0", out, f"{mk}.ffn1")
        _fused_conv(sd, f"{mp}.ffn.1", out, f"{mk}.ffn2")


def _fill_head(sd, prefix, out, family):
    for i in range(3):
        for branch in ("cv2", "cv3", "cv4"):
            p, k = f"{prefix}.{branch}.{i}", f"head.{branch}.{i}"
            if branch == "cv3" and family == "v11":
                for j in ("0", "1"):
                    _fused_conv(sd, f"{p}.{j}.0", out, f"{k}.{j}_dw")
                    _fused_conv(sd, f"{p}.{j}.1", out, f"{k}.{j}_pw")
            else:
                _fused_conv(sd, f"{p}.0", out, f"{k}.0")
                _fused_conv(sd, f"{p}.1", out, f"{k}.1")
            _plain_conv(sd, f"{p}.2", out, f"{k}.2")


# the port's key, the checkpoint's module index and its kind, per family
_V8_LAYOUT = [
    ("b0", 0, "conv"), ("b1", 1, "conv"), ("b2", 2, "c2f"),
    ("b3", 3, "conv"), ("b4", 4, "c2f"), ("b5", 5, "conv"),
    ("b6", 6, "c2f"), ("b7", 7, "conv"), ("b8", 8, "c2f"),
    ("b9", 9, "sppf"), ("h12", 12, "c2f"), ("h15", 15, "c2f"),
    ("h16", 16, "conv"), ("h18", 18, "c2f"), ("h19", 19, "conv"),
    ("h21", 21, "c2f"),
]
_V11_LAYOUT = [
    ("b0", 0, "conv"), ("b1", 1, "conv"), ("b2", 2, "c3k2"),
    ("b3", 3, "conv"), ("b4", 4, "c3k2"), ("b5", 5, "conv"),
    ("b6", 6, "c3k2"), ("b7", 7, "conv"), ("b8", 8, "c3k2"),
    ("b9", 9, "sppf"), ("b10", 10, "c2psa"), ("h13", 13, "c3k2"),
    ("h16", 16, "c3k2"), ("h17", 17, "conv"), ("h19", 19, "c3k2"),
    ("h20", 20, "conv"), ("h22", 22, "c3k2"),
]
# v8's C2f stages with n(6) bottlenecks (the others n(3)); v11's C3k2
# stages that hold C3k blocks whatever the model (the others only with
# c3k_everywhere)
_V8_DEEP = ("b4", "b6")
_V11_C3K = ("b6", "b8", "h22")


def convert_state_dict(sd: dict, name: str) -> dict:
    """An Ultralytics state dict (models.load_ultralytics_checkpoint) ->
    the port's flat dict under the safetensors key names (OIHW, BatchNorm
    folded), the inner block counts from MODEL_CONFIGS[name], as the JAX
    package's convert_state_dict fills init_params' tree."""
    cfg = MODEL_CONFIGS[name]
    out: dict = {}
    layout = _V8_LAYOUT if cfg.family == "v8" else _V11_LAYOUT
    for key, idx, kind in layout:
        prefix = f"model.{idx}"
        if kind == "conv":
            _fused_conv(sd, prefix, out, key)
        elif kind == "sppf":
            _fill_cv1_cv2(sd, prefix, out, key)
        elif kind == "c2f":
            _fill_c2f(sd, prefix, out, key,
                      cfg.n(6) if key in _V8_DEEP else cfg.n(3))
        elif kind == "c3k2":
            _fill_c3k2(sd, prefix, out, key, cfg.n(2),
                       key in _V11_C3K or cfg.c3k_everywhere)
        else:
            _fill_c2psa(sd, prefix, out, key, cfg.n(2))
    _fill_head(sd, f"model.{22 if cfg.family == 'v8' else 23}", out,
               cfg.family)
    return out


def load_pretrained(path: str, name: str) -> dict:
    """An Ultralytics .pt -> the port's flat dict (as load_params gives
    a checkpoint of the JAX package, with the same keys)."""
    return convert_state_dict(load_ultralytics_checkpoint(path), name)


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

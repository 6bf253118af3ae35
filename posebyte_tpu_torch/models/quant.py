"""INT8 quantisation, after posebyte_tpu/models/quant.py: per-output-channel
symmetric int8 weights with the partial-quantisation policy (b0-b4 keep
float weights), activation calibration (percentile or entropy/KL) for the
w8a8 path that Kernel 4 runs, and the calibration cache.

Parameters are the port's flat dict (models.load_params): a conv "key"
holds "key.w" (OIHW) and "key.b"; quantised, "key.w" is int8 and
"key.scale" [O] float32 joins it; calibrated, "key.act_scale" (0-d
float32) too. The calibration cache is the JAX package's JSON, keyed by its
dotted paths (conv_paths), so either package reads the other's.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..core.device import resolve_device, set_numeric_settings
from . import layers as L

# Layers kept high precision (the JAX package's partial-quantisation
# policy: the stem and the first two C2f stages).
PARTIAL_QUANT_SKIP = ("b0", "b1", "b2", "b3", "b4")

# In the parameter tree the children of these keys, and of every "m"
# (the inner blocks of C2f, C3, C3k2 and C2PSA), are list items: the head's
# three levels.
_LIST_PARENTS = ("head.cv2", "head.cv3", "head.cv4")


def _conv_keys(params: dict) -> list[str]:
    """The conv keys of a flat dict (those with both "w" and "b")."""
    return [k[:-2] for k in params
            if k.endswith(".w") and k[:-2] + ".b" in params]


def _quantize_conv(w: np.ndarray, b: np.ndarray):
    """OIHW float weights -> (int8 weights, scale [O], bias), symmetric
    per output channel, with the JAX package's numpy arithmetic."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=(1, 2, 3))            # [c_out]
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale[:, None, None, None]), -127,
                127).astype(np.int8)
    return q, scale, np.asarray(b, np.float32)


def quantize_params(params: dict) -> dict:
    """Quantise every float conv except those of the top-level layers in
    PARTIAL_QUANT_SKIP; returns a new flat dict."""
    out = dict(params)
    for key in _conv_keys(params):
        if key.split(".")[0] in PARTIAL_QUANT_SKIP or key + ".scale" in params:
            continue
        (out[key + ".w"], out[key + ".scale"],
         out[key + ".b"]) = _quantize_conv(params[key + ".w"],
                                           params[key + ".b"])
    return out


def jax_path(key: str) -> str:
    """A conv key of the port ("b6.m.0.cv1", "head.cv2.0.0",
    "b6.m.0.1.cv1") -> the JAX package's dotted path of the same conv
    ("b6.m[0].cv1", "head.cv2[0].0", "b6.m[0][1].cv1"): list and tuple
    items are written [i]. YOLO11's C3k2 holds its inner block i as a
    (kind, params) tuple, so the digit after "m.{i}" is a tuple index."""
    out = ""
    for part in key.split("."):
        last = out.rsplit(".", 1)[-1]
        if part.isdigit() and (last == "m" or out in _LIST_PARENTS
                               or (last.startswith("m[")
                                   and last.count("[") == 1)):
            out += f"[{part}]"
        else:
            out = f"{out}.{part}" if out else part
    return out


def _path_order(path: str):
    """Sort key giving conv_paths the JAX walk's order: dict keys sorted
    as strings (the v11 head's "0_dw" < "0_pw" < ... < "2"), list and
    tuple items by index."""
    order = []
    for part in path.split("."):
        name, *items = part.split("[")
        order.append((0, name))
        order += [(1, int(i[:-1])) for i in items]
    return order


def conv_paths(params: dict) -> dict:
    """{the JAX package's dotted path: the port's conv key} over a flat
    dict, in the JAX walk's order (keys calibration caches)."""
    paths = {jax_path(k): k for k in _conv_keys(params)}
    return {p: paths[p] for p in sorted(paths, key=_path_order)}


def save_calibration_cache(qparams: dict, path: str) -> int:
    """Write the activation scales as the JAX package's cache JSON.
    Returns the number of scales."""
    scales = {p: float(np.asarray(qparams[k + ".act_scale"]))
              for p, k in conv_paths(qparams).items()
              if k + ".act_scale" in qparams}
    with open(path, "w") as f:
        json.dump({"version": 1, "act_scales": scales}, f, indent=1)
    return len(scales)


def load_calibration_cache(qparams: dict, path: str) -> int:
    """Attach cached activation scales (by the JAX dotted path) to the
    weight-quantised convs of `qparams`, in place. Returns the number
    attached."""
    with open(path) as f:
        scales = json.load(f)["act_scales"]
    n = 0
    for p, k in conv_paths(qparams).items():
        if p in scales and k + ".scale" in qparams:
            qparams[k + ".act_scale"] = np.asarray(scales[p], np.float32)
            n += 1
    return n


def _kl_threshold(counts: np.ndarray, width: float,
                  n_quant: int = 128, start_bin: int = 128) -> float:
    """TensorRT-style entropy calibration threshold, after
    posebyte_tpu/models/quant.py::_kl_threshold: over candidate clip points
    i (in bins), pick the one minimising KL(P_i || Q_i), P_i the |x|
    histogram clipped at bin i (outlier mass folded into the last bin) and
    Q_i P_i re-expressed with `n_quant` uniform levels (each level's mass
    spread evenly over its nonzero source bins). Returns (i + 0.5) * width
    for the best i."""
    nbins = counts.shape[0]
    total = counts.sum()
    if total == 0 or width == 0.0:
        return 0.0
    cnt = counts.astype(np.float64)
    tail = np.concatenate([cnt[::-1].cumsum()[::-1], [0.0]])  # sum i..
    best_kl, best_i = np.inf, nbins
    for i in range(start_bin, nbins + 1):
        p = cnt[:i].copy()
        p[i - 1] += tail[i]                 # clip: outliers -> last bin
        nz = cnt[:i] > 0
        gid = (np.arange(i) * n_quant) // i  # bin -> quant level
        sums = np.bincount(gid, weights=cnt[:i], minlength=n_quant)
        nnz = np.bincount(gid, weights=nz.astype(np.float64),
                          minlength=n_quant)
        q = np.where(nz, (sums / np.maximum(nnz, 1.0))[gid], 0.0)
        p /= p.sum()
        qs = q.sum()
        if qs == 0.0:
            continue
        q /= qs
        mask = p > 0
        kl = float(np.sum(p[mask] *
                          np.log(p[mask] / np.maximum(q[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return (best_i + 0.5) * width


def calibrate_activations(qparams: dict, name: str, images: np.ndarray,
                          method: str = "percentile", device=None) -> dict:
    """Run the forward eagerly on the weight-quantised parameters
    (unfolded, float32, normalised RGB images [N, S, S, 3] in 0..1, in
    batches of 16 as the JAX package groups them), record each quantised
    conv's input, and attach act_scale = max(amax, 1e-6) / 127 to it, in
    place; returns qparams.

    method="percentile": amax is the largest over the batches of the
    99.9th percentile of |x|; "entropy": the
    KL threshold (_kl_threshold) of a streaming histogram. device: where
    the forward runs (None: the card). Like a pipeline, it sets the
    process-wide numeric settings first (TF32 off): with TF32 the card's
    scales would hang on whether a pipeline was made before."""
    from .yolo_pose import MODEL_CONFIGS, forward_heads
    if method not in ("percentile", "entropy"):
        raise ValueError(f"unknown calibration method {method!r} "
                         "(expected percentile|entropy)")
    dev = resolve_device(device)
    set_numeric_settings()
    keys = [k for k in _conv_keys(qparams) if k + ".scale" in qparams]
    params = L.prepare_params(qparams, torch.float32, dev)
    recorder = L.CalibrationRecorder(keys, method)
    L._CALIBRATION_RECORDER = recorder
    try:
        with torch.inference_mode():
            for start in range(0, images.shape[0], 16):
                x = torch.from_numpy(np.ascontiguousarray(
                    images[start:start + 16], np.float32)).to(dev)
                forward_heads(params, x, MODEL_CONFIGS[name].family)
    finally:
        L._CALIBRATION_RECORDER = None
    n_attached = 0
    for k in keys:
        rec = recorder.records[k]
        if rec is None:
            continue
        if method == "entropy":
            amax = _kl_threshold(rec.counts, rec.width)
        else:
            amax = max(rec)
        qparams[k + ".act_scale"] = np.asarray(max(amax, 1e-6) / 127.0,
                                               np.float32)
        n_attached += 1
    print(f"[quant] activation calibration ({method}): {n_attached} "
          f"int8 convs over {images.shape[0]} images")
    return qparams


def calibrate_and_quantize(params: dict, name: str, calib_dir: str = "",
                           input_size: int = 640, cache_path: str = "",
                           synthetic_fallback: bool = False,
                           n_synthetic: int = 64,
                           method: str = "percentile", device=None) -> dict:
    """The full int8 build, after the JAX package's: per-channel int8
    weights with the partial-quantisation policy, then activation scales
    from, in order: an existing `cache_path`; images in `calib_dir` (not
    ported: they need the normalised letterbox_image, ROADMAP Queue 1 item
    4); `synthetic_fallback=True`: uniform noise frames from seed 0, the
    JAX package's; else none (weight-only int8). Calibrated scales are
    written to `cache_path` when given."""
    qparams = quantize_params(params)
    if cache_path and os.path.exists(cache_path):
        n = load_calibration_cache(qparams, cache_path)
        print(f"[quant] loaded {n} activation scales from cache "
              f"{cache_path}")
        return qparams
    if calib_dir:
        raise NotImplementedError(
            "calibration images need letterbox_image and an image reader, "
            "not ported yet (ROADMAP Queue 1 item 4); pass cache_path or "
            "synthetic_fallback=True")
    if not synthetic_fallback:
        print("[quant] no calibration source: weight-only int8 "
              "(activations stay float; pass cache_path for the full "
              "w8a8 path)")
        return qparams
    rng = np.random.default_rng(0)
    images = rng.uniform(0.0, 1.0, (n_synthetic, input_size, input_size,
                                    3)).astype(np.float32)
    print("[quant] WARNING: calibrating on SYNTHETIC frames -- activation "
          "scales are unvalidated; accuracy loss is unquantified.")
    qparams = calibrate_activations(qparams, name, images, method=method,
                                    device=device)
    if cache_path:
        n = save_calibration_cache(qparams, cache_path)
        print(f"[quant] wrote {n} activation scales to cache {cache_path}")
    return qparams

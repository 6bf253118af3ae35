"""YOLOv8 building blocks as plain functions on a flat parameter dict.

Counterparts of posebyte_tpu/models/layers.py (conv2d, conv_block,
bottleneck, c2f, sppf, upsample2x, the calibration recorder). Activations
are NCHW tensors kept in channels_last memory, so cuDNN runs its NHWC
kernels; weights are OIHW. BatchNorm is already fused into every conv.
Padding is torch-style symmetric k//2.

A checkpoint's conv comes in one of three flavours (the JAX conv2d's):
float {w, b}; weight-only int8 {w int8, scale, b}; w8a8 {w int8, scale,
act_scale, b}. prepare_params turns them into what conv2d runs: the first
two as a float conv (the int8 weights dequantised once, as
w.to(dtype) * scale.to(dtype)), the third as Kernel 4's packed weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv_int8 import conv_w8a8, pack_weights

# Active calibration recorder (models/quant.py sets a CalibrationRecorder
# while it runs the forward eagerly; None otherwise).
_CALIBRATION_RECORDER = None


class _EntropyHist:
    """Streaming |activation| histogram with a growable range (2048 bins),
    after posebyte_tpu/models/layers.py::_EntropyHist: when a batch exceeds
    the current range the bin width doubles and adjacent bins merge, so
    one pass over the calibration set suffices."""
    NBINS = 2048

    def __init__(self):
        self.counts = np.zeros(self.NBINS, np.int64)
        self.width = 0.0

    def update(self, absx: np.ndarray):
        if absx.size == 0:
            return
        amax = float(absx.max())
        if amax == 0.0:
            return
        if self.width == 0.0:
            self.width = amax / self.NBINS
        while amax > self.NBINS * self.width:
            merged = self.counts[0::2] + self.counts[1::2]
            self.counts = np.concatenate(
                [merged, np.zeros(self.NBINS // 2, np.int64)])
            self.width *= 2.0
        idx = np.minimum((absx / self.width).astype(np.int64),
                         self.NBINS - 1)
        self.counts += np.bincount(idx, minlength=self.NBINS) \
            .astype(np.int64)


def percentile_999(absx: torch.Tensor) -> float:
    """jnp.percentile(absx, 99.9) (linear interpolation) for any size
    (torch.quantile refuses inputs above 2^24 elements), with JAX's float32
    arithmetic: q = float32(99.9) / 100, position q * (n - 1), the two
    neighbouring order statistics weighted by its fraction."""
    flat = absx.reshape(-1).float()
    n = np.float32(flat.numel())
    pos = (np.float32(99.9) / np.float32(100)) * (n - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = pos - lo
    w_lo = np.float32(1) - w_hi
    v = torch.sort(flat).values[[int(lo), int(hi)]].cpu().numpy()
    return float(v[0] * w_lo + v[1] * w_hi)


class CalibrationRecorder:
    """What calibration records of the convs it names: per conv key, None
    until the conv runs, then for method "percentile" the list of each
    batch's 99.9th percentile of |x|, for "entropy" a streaming |x|
    histogram (models/quant.py::_kl_threshold reads it)."""

    def __init__(self, keys, method: str):
        self.method = method
        self.records = dict.fromkeys(keys)

    def record(self, key: str, x: torch.Tensor):
        if key not in self.records:
            return
        if self.method == "entropy":
            if self.records[key] is None:
                self.records[key] = _EntropyHist()
            self.records[key].update(x.float().abs().cpu().numpy().ravel())
        else:
            if self.records[key] is None:
                self.records[key] = []
            self.records[key].append(percentile_999(x.float().abs()))


def prepare_params(params: dict, dtype: torch.dtype, device) -> dict:
    """A checkpoint's flat dict (numpy or tensors, models.load_params) ->
    the tensors conv2d runs on, on `device`:
    - float and weight-only int8 convs: "w" in `dtype` (channels_last) and
      "b" in `dtype`; weight-only weights are dequantised here once, as
      w.to(dtype) * scale.to(dtype) (the JAX conv2d does it per call);
    - w8a8 convs: "wq" Kernel 4's packed int8 weights, "dq" the dequant
      factor float32(act_scale * scale) [O], "act_scale" a 0-d float32
      tensor on the device (the quantisation divides by it), "b"
      float32."""
    out = {}
    for key in params:
        if not key.endswith(".w"):
            continue
        p = key[:-2]
        w = torch.as_tensor(np.asarray(params[key]))
        b = torch.as_tensor(np.asarray(params[p + ".b"], np.float32))
        if p + ".act_scale" in params:
            s_x = np.asarray(params[p + ".act_scale"], np.float32)
            scale = np.asarray(params[p + ".scale"], np.float32)
            out[p + ".wq"] = pack_weights(w).to(device)
            out[p + ".dq"] = torch.from_numpy(
                np.ascontiguousarray(s_x * scale)).to(device)
            out[p + ".act_scale"] = torch.from_numpy(s_x).to(device)
            out[p + ".b"] = b.to(device)
            continue
        if p + ".scale" in params:
            scale = torch.as_tensor(np.asarray(params[p + ".scale"],
                                               np.float32))
            w = w.to(dtype) * scale.to(dtype)[:, None, None, None]
        out[key] = w.to(device, dtype).contiguous(
            memory_format=torch.channels_last)
        out[p + ".b"] = b.to(device, dtype)
    return out


def conv2d(p: dict, key: str, x: torch.Tensor, stride: int = 1):
    """Conv with bias on prepare_params' tensors: a float conv (cuDNN on
    the card) for p[key + ".w"] [O, I, k, k], or the w8a8 conv for
    p[key + ".wq"]: x quantised to int8 with the calibrated scale and
    convolved, on the card in one Kernel 4 launch, out in x's dtype."""
    if _CALIBRATION_RECORDER is not None:
        _CALIBRATION_RECORDER.record(key, x)
    wq = p.get(key + ".wq")
    if wq is not None:
        k = round(wq.shape[1] ** 0.5)
        return conv_w8a8(x, p[key + ".act_scale"], wq, p[key + ".dq"],
                         p[key + ".b"], k, stride)
    w = p[key + ".w"]
    return F.conv2d(x, w, p[key + ".b"], stride=stride,
                    padding=w.shape[-1] // 2)


def conv_block(p: dict, key: str, x: torch.Tensor, stride: int = 1):
    """Conv + (folded) BN + SiLU: ultralytics `Conv`."""
    return F.silu(conv2d(p, key, x, stride))


def bottleneck(p: dict, key: str, x: torch.Tensor, add: bool):
    y = conv_block(p, key + ".cv2", conv_block(p, key + ".cv1", x))
    return x + y if add else y


def c2f(p: dict, key: str, x: torch.Tensor, shortcut: bool):
    """CSP bottleneck with 2 convs and n inner bottlenecks (ultralytics
    C2f); n is the number of bottlenecks the checkpoint holds."""
    y = conv_block(p, key + ".cv1", x)
    c_h = y.shape[1] // 2
    parts = [y[:, :c_h], y[:, c_h:]]
    i = 0
    while f"{key}.m.{i}.cv1.b" in p:
        parts.append(bottleneck(p, f"{key}.m.{i}", parts[-1], shortcut))
        i += 1
    return conv_block(p, key + ".cv2", torch.cat(parts, dim=1))


def sppf(p: dict, key: str, x: torch.Tensor, k: int = 5):
    """Spatial pyramid pooling (fast): 3 chained k x k maxpools, concat."""
    y = conv_block(p, key + ".cv1", x)
    p1 = F.max_pool2d(y, k, 1, k // 2)
    p2 = F.max_pool2d(p1, k, 1, k // 2)
    p3 = F.max_pool2d(p2, k, 1, k // 2)
    return conv_block(p, key + ".cv2", torch.cat([y, p1, p2, p3], dim=1))


def upsample2x(x: torch.Tensor):
    """Nearest-neighbour 2x upsample (ultralytics nn.Upsample)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")

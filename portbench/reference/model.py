"""The plain reference of the pose models, in float32 PyTorch, on a
checkpoint read here from its safetensors bytes. A configuration's
`family` names its network, portbench/reference/nets/<family>.py (v8:
Ultralytics' yolov8-pose.yaml, v11: yolo11-pose.yaml), written out layer
by layer from the published definition at the scale the configuration
names, on the blocks here.

Every conv is Ultralytics' Conv with its BatchNorm already folded into
the weights and bias (the checkpoints hold them folded): conv, then SiLU
where the block has one. The blocks follow the published definitions
(Bottleneck, C2f, C3, C3k2, SPPF, Attention, C2PSA, the head's plain
branch); nothing of the program under test is imported.

A `Convs` object runs each conv, so that one forward serves four needs:
float32 (the reference), w8a8 and w4a4 fake-quantised convs with exact
integer sums (the int8 configuration's reference and its control), and
recording each conv's input (the activation calibration).
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch
import torch.nn.functional as F

from ..harness.spec import ROOT, load_module

REG_MAX = 16
NK = 51

_ST_DTYPES = {"F32": np.float32, "F64": np.float64, "F16": np.float16,
              "I8": np.int8, "I32": np.int32, "I64": np.int64}


def read_checkpoint(path: str) -> dict:
    """A safetensors checkpoint -> {key: float32 or int8 numpy}, conv
    weights turned from the file's HWIO into OIHW."""
    with open(path, "rb") as f:
        blob = f.read()
    (n,) = struct.unpack("<Q", blob[:8])
    header = json.loads(blob[8:8 + n].decode("utf-8"))
    header.pop("__metadata__", None)
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        arr = np.frombuffer(data[begin:end], _ST_DTYPES[info["dtype"]]) \
            .reshape(info["shape"])
        if arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        out[name] = np.array(arr, order="C")
    return out


def quantize_weight(w: np.ndarray, levels: int):
    """Symmetric per-output-channel quantisation of OIHW weights to the
    integers -levels..levels: (integer values as float32, scale [O])."""
    w = np.asarray(w, np.float32)
    amax = np.max(np.abs(w), axis=(1, 2, 3))
    scale = np.where(amax > 0, amax / float(levels), 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale[:, None, None, None]), -levels, levels)
    return q.astype(np.float32), scale


def percentile_999(absx: torch.Tensor) -> float:
    """The 99.9th percentile of |x| by linear interpolation between order
    statistics, the position computed in float32 arithmetic."""
    flat = absx.reshape(-1).float()
    n = np.float32(flat.numel())
    pos = (np.float32(99.9) / np.float32(100)) * (n - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = pos - lo
    w_lo = np.float32(1) - w_hi
    v = torch.sort(flat).values[[int(lo), int(hi)]].cpu().numpy()
    return float(v[0] * w_lo + v[1] * w_hi)


def is_depthwise(key: str) -> bool:
    return key.endswith("_dw") or key.endswith(".attn.pe")


class Convs:
    """Runs the model's convs on `device`.

    mode "float": float32 convs on the checkpoint's weights.
    mode "quant": the convs outside `skip` (top-level layer names) take
    integer weights (per-channel, -levels..levels) and, when act_scales
    holds their key, integer activations clamp(round(x / s), -levels,
    levels) (round half to even), summed exactly in float64 and scaled
    back by s * scale; with no act_scales (calibration) the activations
    stay float32 and each quantised conv's input is handed to `record`.
    """

    def __init__(self, params: dict, device, mode: str = "float",
                 levels: int = 127, skip=(), act_scales=None, record=None):
        self.levels = levels
        self.act_scales = act_scales
        self.record = record
        self.w, self.b, self.s = {}, {}, {}
        for key in params:
            if not key.endswith(".w"):
                continue
            k = key[:-2]
            w = np.asarray(params[key], np.float32)
            if mode == "quant" and k.split(".")[0] not in skip:
                q, scale = quantize_weight(w, levels)
                self.s[k] = scale
                w = q if act_scales is not None else \
                    q * scale[:, None, None, None]
            self.w[k] = torch.from_numpy(w).to(device)
            self.b[k] = torch.from_numpy(
                np.asarray(params[k + ".b"], np.float32)).to(device)

    def __call__(self, key: str, x: torch.Tensor, stride: int = 1,
                 groups: int = 1) -> torch.Tensor:
        w, b = self.w[key], self.b[key]
        pad = w.shape[-1] // 2
        if key in self.s and self.record is not None:
            self.record(key, x)
        if key not in self.s or self.act_scales is None:
            return F.conv2d(x, w, b, stride=stride, padding=pad,
                            groups=groups)
        s_x = torch.tensor(np.float32(self.act_scales[key]),
                           device=x.device)
        q = torch.clamp(torch.round(x / s_x), -self.levels, self.levels)
        acc = F.conv2d(q.double(), w.double(), stride=stride, padding=pad,
                       groups=groups)
        dq = torch.from_numpy(np.float32(self.act_scales[key])
                              * self.s[key]).to(x.device)
        return acc.float() * dq[None, :, None, None] \
            + b[None, :, None, None]


# ---------------------------------------------------------------- blocks

def conv_act(cv, key, x, stride=1):
    return F.silu(cv(key, x, stride))


def bottleneck(cv, key, x, add):
    y = conv_act(cv, key + ".cv2", conv_act(cv, key + ".cv1", x))
    return x + y if add else y


def _has(cv, key):
    return key in cv.w


def c2f(cv, key, x, shortcut):
    y = conv_act(cv, key + ".cv1", x)
    c = y.shape[1] // 2
    parts = [y[:, :c], y[:, c:]]
    i = 0
    while _has(cv, f"{key}.m.{i}.cv1"):
        parts.append(bottleneck(cv, f"{key}.m.{i}", parts[-1], shortcut))
        i += 1
    return conv_act(cv, key + ".cv2", torch.cat(parts, 1))


def c3(cv, key, x):
    a = conv_act(cv, key + ".cv1", x)
    i = 0
    while _has(cv, f"{key}.m.{i}.cv1"):
        a = bottleneck(cv, f"{key}.m.{i}", a, True)
        i += 1
    b = conv_act(cv, key + ".cv2", x)
    return conv_act(cv, key + ".cv3", torch.cat([a, b], 1))


def c3k2(cv, key, x):
    y = conv_act(cv, key + ".cv1", x)
    c = y.shape[1] // 2
    parts = [y[:, :c], y[:, c:]]
    i = 0
    while _has(cv, f"{key}.m.{i}.1.cv1"):
        m = f"{key}.m.{i}.1"
        parts.append(c3(cv, m, parts[-1]) if _has(cv, m + ".cv3")
                     else bottleneck(cv, m, parts[-1], True))
        i += 1
    return conv_act(cv, key + ".cv2", torch.cat(parts, 1))


def sppf(cv, key, x):
    y = conv_act(cv, key + ".cv1", x)
    p1 = F.max_pool2d(y, 5, 1, 2)
    p2 = F.max_pool2d(p1, 5, 1, 2)
    p3 = F.max_pool2d(p2, 5, 1, 2)
    return conv_act(cv, key + ".cv2", torch.cat([y, p1, p2, p3], 1))


def attention(cv, key, x, num_heads):
    """Ultralytics Attention (attn_ratio 0.5): per head a query and key of
    head_dim / 2 channels and a value of head_dim, softmax(q^T k /
    sqrt(key_dim)), plus a depthwise positional conv of v, then proj."""
    B, C, H, W = x.shape
    hd = C // num_heads
    kd = hd // 2
    N = H * W
    qkv = cv(key + ".qkv", x).reshape(B, num_heads, 2 * kd + hd, N)
    q, k, v = qkv.split([kd, kd, hd], dim=2)
    attn = torch.softmax((q.transpose(-2, -1) @ k) * kd ** -0.5, dim=-1)
    out = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
    pe = cv(key + ".pe", v.reshape(B, C, H, W), 1, C)
    return cv(key + ".proj", out + pe)


def c2psa(cv, key, x):
    y = conv_act(cv, key + ".cv1", x)
    c = y.shape[1] // 2
    a, b = y[:, :c], y[:, c:]
    i = 0
    while _has(cv, f"{key}.m.{i}.ffn1"):
        m = f"{key}.m.{i}"
        b = b + attention(cv, m + ".attn", b, max(1, c // 64))
        b = b + cv(m + ".ffn2", conv_act(cv, m + ".ffn1", b))
        i += 1
    return conv_act(cv, key + ".cv2", torch.cat([a, b], 1))


def up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def head_branch(cv, name, i, x):
    """The head's plain branch `name` at level i: two 3x3 convs with
    SiLU, then a 1x1 conv."""
    k = f"head.{name}.{i}"
    y = conv_act(cv, f"{k}.1", conv_act(cv, f"{k}.0", x))
    return cv(f"{k}.2", y)


def network(family: str, root: str = ROOT):
    """The network of `family`: portbench/reference/nets/<family>.py
    under `root`, with STRIDES (one a pyramid level, in order),
    pyramid(cv, x) -> the levels' feature maps, and head(cv, i, x) -> the
    box, class and keypoint logits at level i."""
    return load_module("reference/nets", family, root)


def forward(cv, x_nchw: torch.Tensor, family: str, root: str = ROOT):
    """Normalised RGB images [B, 3, S, S] -> (box logits [B, A, 64], class
    logits [B, A, 1], raw keypoints [B, A, 51]), anchors row-major per
    level in stride order."""
    net = network(family, root)
    levels = net.pyramid(cv, x_nchw)
    outs = [[] for _ in range(3)]
    for i, f in enumerate(levels):
        for j, t in enumerate(net.head(cv, i, f)):
            outs[j].append(t.flatten(2).transpose(1, 2))
    return tuple(torch.cat(o, 1) for o in outs)


def anchors(input_size: int, device, family: str, root: str = ROOT):
    """Anchor centres [A, 2] (grid units) and strides [A], over the
    network's STRIDES."""
    pts, strides = [], []
    for s in network(family, root).STRIDES:
        n = input_size // s
        c = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(c, c, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strides.append(torch.full((n * n,), float(s), device=device))
    return torch.cat(pts), torch.cat(strides)


def calibrate(params: dict, family: str, images: np.ndarray, skip,
              device, batch: int = 16, root: str = ROOT) -> dict:
    """Activation scales of the quantised convs: the forward on
    weight-quantised (int8, dequantised) float32 weights over normalised
    RGB images [N, S, S, 3], each conv's scale max over batches of the
    99.9th percentile of |input|, / 127."""
    rec: dict = {}
    cv = Convs(params, device, "quant", 127, skip,
               record=lambda k, x: rec.setdefault(k, []).append(
                   percentile_999(x.abs())))
    with torch.no_grad():
        for s in range(0, len(images), batch):
            x = torch.from_numpy(np.ascontiguousarray(
                images[s:s + batch])).to(device).permute(0, 3, 1, 2)
            forward(cv, x, family, root)
    return {k: np.float32(max(max(v), 1e-6) / 127.0) for k, v in rec.items()}

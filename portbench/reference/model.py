"""The plain reference of the two pose models, in float32 PyTorch: the
YOLOv8-pose and YOLO11-pose networks of Ultralytics' yolov8-pose.yaml and
yolo11-pose.yaml at the scale a configuration file names, on a checkpoint
read here from its safetensors bytes.

Every conv is Ultralytics' Conv with its BatchNorm already folded into
the weights and bias (the checkpoints hold them folded): conv, then SiLU
where the block has one. The network is written out layer by layer from
the published definitions (C2f, C3k2, C3k, SPPF, C2PSA, the pose head with
DFL and, in YOLO11, depthwise class branches); nothing of the program
under test is imported.

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


def backbone_neck(cv, x, family):
    x = conv_act(cv, "b1", conv_act(cv, "b0", x, 2), 2)
    if family == "v8":
        x = c2f(cv, "b2", x, True)
        p3 = c2f(cv, "b4", conv_act(cv, "b3", x, 2), True)
        p4 = c2f(cv, "b6", conv_act(cv, "b5", p3, 2), True)
        x = c2f(cv, "b8", conv_act(cv, "b7", p4, 2), True)
        p5 = sppf(cv, "b9", x)
        n4 = c2f(cv, "h12", torch.cat([up(p5), p4], 1), False)
        o3 = c2f(cv, "h15", torch.cat([up(n4), p3], 1), False)
        o4 = c2f(cv, "h18", torch.cat([conv_act(cv, "h16", o3, 2), n4], 1),
                 False)
        o5 = c2f(cv, "h21", torch.cat([conv_act(cv, "h19", o4, 2), p5], 1),
                 False)
        return o3, o4, o5
    x = c3k2(cv, "b2", x)
    p3 = c3k2(cv, "b4", conv_act(cv, "b3", x, 2))
    p4 = c3k2(cv, "b6", conv_act(cv, "b5", p3, 2))
    x = c3k2(cv, "b8", conv_act(cv, "b7", p4, 2))
    p5 = c2psa(cv, "b10", sppf(cv, "b9", x))
    n4 = c3k2(cv, "h13", torch.cat([up(p5), p4], 1))
    o3 = c3k2(cv, "h16", torch.cat([up(n4), p3], 1))
    o4 = c3k2(cv, "h19", torch.cat([conv_act(cv, "h17", o3, 2), n4], 1))
    o5 = c3k2(cv, "h22", torch.cat([conv_act(cv, "h20", o4, 2), p5], 1))
    return o3, o4, o5


def head_level(cv, i, x, family):
    def branch(name):
        k = f"head.{name}.{i}"
        y = conv_act(cv, f"{k}.1", conv_act(cv, f"{k}.0", x))
        return cv(f"{k}.2", y)

    if family == "v11":
        k = f"head.cv3.{i}"
        c = F.silu(cv(f"{k}.0_dw", x, 1, x.shape[1]))
        c = conv_act(cv, f"{k}.0_pw", c)
        c = F.silu(cv(f"{k}.1_dw", c, 1, c.shape[1]))
        c = conv_act(cv, f"{k}.1_pw", c)
        cls = cv(f"{k}.2", c)
    else:
        cls = branch("cv3")
    return branch("cv2"), cls, branch("cv4")


def forward(cv, x_nchw: torch.Tensor, family: str):
    """Normalised RGB images [B, 3, S, S] -> (box logits [B, A, 64], class
    logits [B, A, 1], raw keypoints [B, A, 51]), anchors row-major per
    level in stride order."""
    outs = [[], [], []]
    for i, f in enumerate(backbone_neck(cv, x_nchw, family)):
        for j, t in enumerate(head_level(cv, i, f, family)):
            outs[j].append(t.flatten(2).transpose(1, 2))
    return tuple(torch.cat(o, 1) for o in outs)


def anchors(input_size: int, device):
    """Anchor centres [A, 2] (grid units) and strides [A]."""
    pts, strides = [], []
    for s in (8, 16, 32):
        n = input_size // s
        c = torch.arange(n, dtype=torch.float32, device=device) + 0.5
        gy, gx = torch.meshgrid(c, c, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strides.append(torch.full((n * n,), float(s), device=device))
    return torch.cat(pts), torch.cat(strides)


def calibrate(params: dict, family: str, images: np.ndarray, skip,
              device, batch: int = 16) -> dict:
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
            forward(cv, x, family)
    return {k: np.float32(max(max(v), 1e-6) / 127.0) for k, v in rec.items()}

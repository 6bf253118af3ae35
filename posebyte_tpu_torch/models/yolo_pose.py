"""YOLOv8-pose and YOLO11-pose forward passes, after
posebyte_tpu/models/yolo_pose.py (ModelConfig, init_params and
_head_init, the two backbones and necks, _head_level, forward_head_maps,
forward_heads, make_anchors_levels, make_anchors, _dfl, decode_dense,
forward_raw and the build_model* closures).

The head layout matches the JAX package: box logits [B, A, 64], class
logits [B, A, 1], raw keypoints [B, A, 51], with A the row-major flatten of
the three pyramid levels in stride order (8400 anchors at 640);
forward_head_maps gives them per level, unconcatenated. forward_raw gives
the reference engine's dense tensor [B, 56, A].
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import layers as L

REG_MAX = 16
NUM_CLASSES = 1
NK = 51          # 17 keypoints * 3


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A model's scaling, as the JAX package's ModelConfig
    (posebyte_tpu/models/yolo_pose.py:36-72): the layer counts and widths
    models.weights.convert_state_dict reads a checkpoint by."""
    name: str
    family: str              # "v8" | "v11"
    depth: float
    width: float
    max_channels: int
    c3k_everywhere: bool = False   # v11 m/l/x: every C3k2 holds C3k blocks

    def ch(self, c: int) -> int:
        """Scaled channel count, rounded up to a multiple of 8
        (ultralytics make_divisible)."""
        c = min(c, self.max_channels)
        return max(8, int(math.ceil(c * self.width / 8) * 8))

    def n(self, n: int) -> int:
        """Scaled count of a stage's inner blocks."""
        return max(1, round(n * self.depth))


MODEL_CONFIGS = {
    "yolov8n-pose": ModelConfig("yolov8n-pose", "v8", 0.33, 0.25, 1024),
    "yolov8s-pose": ModelConfig("yolov8s-pose", "v8", 0.33, 0.50, 1024),
    "yolov8m-pose": ModelConfig("yolov8m-pose", "v8", 0.67, 0.75, 768),
    "yolov8l-pose": ModelConfig("yolov8l-pose", "v8", 1.00, 1.00, 512),
    "yolov8x-pose": ModelConfig("yolov8x-pose", "v8", 1.00, 1.25, 512),
    "yolo11n-pose": ModelConfig("yolo11n-pose", "v11", 0.50, 0.25, 1024),
    "yolo11s-pose": ModelConfig("yolo11s-pose", "v11", 0.50, 0.50, 1024),
    "yolo11m-pose": ModelConfig("yolo11m-pose", "v11", 0.50, 1.00, 512,
                                c3k_everywhere=True),
    "yolo11l-pose": ModelConfig("yolo11l-pose", "v11", 1.00, 1.00, 512,
                                c3k_everywhere=True),
    "yolo11x-pose": ModelConfig("yolo11x-pose", "v11", 1.00, 1.50, 512,
                                c3k_everywhere=True),
}


def as_generator(seed) -> torch.Generator:
    """A CPU torch.Generator: `seed` itself when it is one, else a new one
    seeded with the int `seed`."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def _head_init(p: dict, g: torch.Generator, cfg: ModelConfig, chs):
    """The pose head's parameters over the three pyramid levels, branch by
    branch as the JAX tree lists them (head.cv2.{0,1,2}, head.cv3...,
    head.cv4...)."""
    c2 = max(16, chs[0] // 4, 4 * REG_MAX)
    c3 = max(chs[0], min(NUM_CLASSES, 100))
    c4 = max(chs[0] // 4, NK)
    for i, ch in enumerate(chs):
        k = f"head.cv2.{i}"
        L.conv_init(p, k + ".0", g, ch, c2, 3)
        L.conv_init(p, k + ".1", g, c2, c2, 3)
        L.conv_init(p, k + ".2", g, c2, 4 * REG_MAX, 1)
    for i, ch in enumerate(chs):
        k = f"head.cv3.{i}"
        if cfg.family == "v11":
            L.dwconv_init(p, k + ".0_dw", g, ch, 3)
            L.conv_init(p, k + ".0_pw", g, ch, c3, 1)
            L.dwconv_init(p, k + ".1_dw", g, c3, 3)
            L.conv_init(p, k + ".1_pw", g, c3, c3, 1)
        else:
            L.conv_init(p, k + ".0", g, ch, c3, 3)
            L.conv_init(p, k + ".1", g, c3, c3, 3)
        L.conv_init(p, k + ".2", g, c3, NUM_CLASSES, 1)
    for i, ch in enumerate(chs):
        k = f"head.cv4.{i}"
        L.conv_init(p, k + ".0", g, ch, c4, 3)
        L.conv_init(p, k + ".1", g, c4, c4, 3)
        L.conv_init(p, k + ".2", g, c4, NK, 1)


def init_params(seed=0, name: str = "yolov8n-pose") -> dict:
    """Random weights for the named model: the port's flat dict of float32
    numpy arrays (OIHW), with the keys, shapes and dtypes of
    params_from_jax(JAX init_params(key, name)). He-normal weights and zero
    biases, drawn from `seed` (an int or a torch.Generator); the values
    are not JAX's, whose generator PyTorch does not have."""
    cfg = MODEL_CONFIGS[name]
    g = as_generator(seed)
    ch = cfg.ch
    p: dict = {}
    if cfg.family == "v8":
        d3, d6 = cfg.n(3), cfg.n(6)
        L.conv_init(p, "b0", g, 3, ch(64), 3)
        L.conv_init(p, "b1", g, ch(64), ch(128), 3)
        L.c2f_init(p, "b2", g, ch(128), ch(128), d3)
        L.conv_init(p, "b3", g, ch(128), ch(256), 3)
        L.c2f_init(p, "b4", g, ch(256), ch(256), d6)
        L.conv_init(p, "b5", g, ch(256), ch(512), 3)
        L.c2f_init(p, "b6", g, ch(512), ch(512), d6)
        L.conv_init(p, "b7", g, ch(512), ch(1024), 3)
        L.c2f_init(p, "b8", g, ch(1024), ch(1024), d3)
        L.sppf_init(p, "b9", g, ch(1024), ch(1024))
        L.c2f_init(p, "h12", g, ch(1024) + ch(512), ch(512), d3)
        L.c2f_init(p, "h15", g, ch(512) + ch(256), ch(256), d3)
        L.conv_init(p, "h16", g, ch(256), ch(256), 3)
        L.c2f_init(p, "h18", g, ch(256) + ch(512), ch(512), d3)
        L.conv_init(p, "h19", g, ch(512), ch(512), 3)
        L.c2f_init(p, "h21", g, ch(512) + ch(1024), ch(1024), d3)
    else:
        d2, ck = cfg.n(2), cfg.c3k_everywhere
        L.conv_init(p, "b0", g, 3, ch(64), 3)
        L.conv_init(p, "b1", g, ch(64), ch(128), 3)
        L.c3k2_init(p, "b2", g, ch(128), ch(256), d2, ck, e=0.25)
        L.conv_init(p, "b3", g, ch(256), ch(256), 3)
        L.c3k2_init(p, "b4", g, ch(256), ch(512), d2, ck, e=0.25)
        L.conv_init(p, "b5", g, ch(512), ch(512), 3)
        L.c3k2_init(p, "b6", g, ch(512), ch(512), d2, True)
        L.conv_init(p, "b7", g, ch(512), ch(1024), 3)
        L.c3k2_init(p, "b8", g, ch(1024), ch(1024), d2, True)
        L.sppf_init(p, "b9", g, ch(1024), ch(1024))
        L.c2psa_init(p, "b10", g, ch(1024), d2)
        L.c3k2_init(p, "h13", g, ch(1024) + ch(512), ch(512), d2, ck)
        # v11's layer 4 is ch(512) wide, so the P3 concat is 2 ch(512)
        L.c3k2_init(p, "h16", g, ch(512) + ch(512), ch(256), d2, ck)
        L.conv_init(p, "h17", g, ch(256), ch(256), 3)
        L.c3k2_init(p, "h19", g, ch(256) + ch(512), ch(512), d2, ck)
        L.conv_init(p, "h20", g, ch(512), ch(512), 3)
        L.c3k2_init(p, "h22", g, ch(512) + ch(1024), ch(1024), d2, True)
    _head_init(p, g, cfg, (ch(256), ch(512), ch(1024)))
    return p


def _stem(p, x):
    return L.conv_block(p, "b1", L.conv_block(p, "b0", x, 2), 2)


def _backbone_neck_v8(p, x):
    x = L.c2f(p, "b2", x, True)
    x = L.conv_block(p, "b3", x, 2)
    p3 = L.c2f(p, "b4", x, True)
    x = L.conv_block(p, "b5", p3, 2)
    p4 = L.c2f(p, "b6", x, True)
    x = L.conv_block(p, "b7", p4, 2)
    x = L.c2f(p, "b8", x, True)
    p5 = L.sppf(p, "b9", x)

    n4 = L.c2f(p, "h12", torch.cat([L.upsample2x(p5), p4], dim=1), False)
    o3 = L.c2f(p, "h15", torch.cat([L.upsample2x(n4), p3], dim=1), False)
    d4 = torch.cat([L.conv_block(p, "h16", o3, 2), n4], dim=1)
    o4 = L.c2f(p, "h18", d4, False)
    d5 = torch.cat([L.conv_block(p, "h19", o4, 2), p5], dim=1)
    o5 = L.c2f(p, "h21", d5, False)
    return o3, o4, o5


def _backbone_neck_v11(p, x):
    x = L.c3k2(p, "b2", x)
    x = L.conv_block(p, "b3", x, 2)
    p3 = L.c3k2(p, "b4", x)           # ch(512) wide, unlike v8's ch(256)
    x = L.conv_block(p, "b5", p3, 2)
    p4 = L.c3k2(p, "b6", x)
    x = L.conv_block(p, "b7", p4, 2)
    x = L.c3k2(p, "b8", x)
    x = L.sppf(p, "b9", x)
    p5 = L.c2psa(p, "b10", x)

    n4 = L.c3k2(p, "h13", torch.cat([L.upsample2x(p5), p4], dim=1))
    o3 = L.c3k2(p, "h16", torch.cat([L.upsample2x(n4), p3], dim=1))
    d4 = torch.cat([L.conv_block(p, "h17", o3, 2), n4], dim=1)
    o4 = L.c3k2(p, "h19", d4)
    d5 = torch.cat([L.conv_block(p, "h20", o4, 2), p5], dim=1)
    o5 = L.c3k2(p, "h22", d5)
    return o3, o4, o5


_BACKBONES = {"v8": _backbone_neck_v8, "v11": _backbone_neck_v11}


def _flat_level(t: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C] (row-major anchors, as the JAX NHWC
    reshape gives them)."""
    B, Cc = t.shape[:2]
    return t.permute(0, 2, 3, 1).reshape(B, -1, Cc)


def _head_level(p, i, x, family):
    def branch(name):
        k = f"head.{name}.{i}"
        y = L.conv_block(p, f"{k}.1", L.conv_block(p, f"{k}.0", x))
        return _flat_level(L.conv2d(p, f"{k}.2", y))

    if family != "v11":
        return branch("cv2"), branch("cv3"), branch("cv4")
    # YOLO11's class branch: depthwise -> pointwise, twice, then 1x1
    k = f"head.cv3.{i}"
    c = L.dwconv_block(p, f"{k}.0_dw", x)
    c = L.conv_block(p, f"{k}.0_pw", c)
    c = L.dwconv_block(p, f"{k}.1_dw", c)
    c = L.conv_block(p, f"{k}.1_pw", c)
    return branch("cv2"), _flat_level(L.conv2d(p, f"{k}.2", c)), \
        branch("cv4")


def forward_head_maps(params: dict, x: torch.Tensor, family: str = "v8",
                      packed_stem: int = 0):
    """Input [B, S, S, 3] NHWC -> the undecoded head maps per pyramid
    level: a tuple of (box [B, A_l, 64], cls [B, A_l, 1], kpt [B, A_l, 51])
    in stride order, A_l = H_l * W_l row-major, with no concatenation
    across levels (the producer of ops.decode.decode_topk_levels).
    Computed in x's dtype; params: prepare_params' tensors; family: "v8" or
    "v11" (ModelConfig.family).

    packed_stem=P > 1 runs the first two convs of P frames at once as one
    grouped conv (layers.packed_stem) when B divides by P, and the plain
    stem otherwise."""
    if family not in _BACKBONES:
        raise ValueError(f"unknown model family {family!r}")
    x = x.permute(0, 3, 1, 2)          # NCHW view of NHWC memory
    if packed_stem > 1 and x.shape[0] % packed_stem == 0:
        x = L.packed_stem(params, "b0", "b1", x, packed_stem)
    else:
        x = _stem(params, x)
    feats = _BACKBONES[family](params, x)
    return tuple(_head_level(params, i, f, family)
                 for i, f in enumerate(feats))


def forward_heads(params: dict, x: torch.Tensor, family: str = "v8",
                  packed_stem: int = 0):
    """Input [B, S, S, 3] NHWC -> undecoded head outputs
    (box_logits [B, A, 64], cls_logits [B, A, 1], kpt_raw [B, A, 51]): the
    concatenation of forward_head_maps over the levels."""
    levels = forward_head_maps(params, x, family, packed_stem)
    return tuple(torch.cat([lv[j] for lv in levels], dim=1)
                 for j in range(3))


@functools.lru_cache(maxsize=8)
def make_anchors_levels(input_size: int = 640, strides=(8, 16, 32)):
    """Per pyramid level, in stride order: (anchor centres [A_l, 2] in grid
    units, strides [A_l]) as float32 numpy. Level l's anchors take the
    global indices [offset_l, offset_l + A_l) of make_anchors."""
    per = []
    for s in strides:
        n = input_size // s
        xs = np.arange(n, dtype=np.float32) + 0.5
        gy, gx = np.meshgrid(xs, xs, indexing="ij")
        per.append((np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1),
                    np.full((n * n,), s, np.float32)))
    return tuple(per)


@functools.lru_cache(maxsize=8)
def make_anchors(input_size: int = 640, strides=(8, 16, 32)):
    """Anchor centres (grid units) and per-anchor stride, concatenated over
    levels: ([A, 2], [A]) float32 numpy."""
    per = make_anchors_levels(input_size, strides)
    return (np.concatenate([p for p, _ in per], 0),
            np.concatenate([s for _, s in per], 0))


@functools.lru_cache(maxsize=8)
def anchor_tensors(input_size: int, device: torch.device):
    """make_anchors' arrays as float32 tensors on `device`, made once per
    size and device (a copy from host memory each call would wait for the
    device's queue)."""
    anchors, strides = make_anchors(input_size)
    return (torch.from_numpy(anchors).to(device),
            torch.from_numpy(strides).to(device))


def _dfl(box_logits: torch.Tensor) -> torch.Tensor:
    """Distribution-focal decode: [..., 4, REG_MAX] logits -> [..., 4]
    expected distances (softmax expectation over the bins)."""
    prob = torch.softmax(box_logits.float(), dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32,
                        device=box_logits.device)
    return (prob * bins).sum(dim=-1)


def decode_dense(box: torch.Tensor, cls: torch.Tensor, kpt: torch.Tensor,
                 input_size: int) -> torch.Tensor:
    """Every anchor decoded -> [B, 56, A] float32, the reference engine's
    output tensor: rows 0-3 the box cxcywh in input pixels
    (ultralytics dist2bbox(xywh=True)), row 4 the sigmoid confidence, rows
    5-55 the 17 keypoints (x, y in input pixels, sigmoid confidence)."""
    anchors, strides = anchor_tensors(input_size, box.device)  # [A, 2], [A]
    B, A = box.shape[:2]
    d = _dfl(box.reshape(B, A, 4, REG_MAX))                     # [B, A, 4]
    x1y1 = anchors - d[..., :2]
    x2y2 = anchors + d[..., 2:]
    cxy = (x1y1 + x2y2) * 0.5 * strides[:, None]
    wh = (x2y2 - x1y1) * strides[:, None]
    conf = torch.sigmoid(cls.float())                           # [B, A, 1]
    k3 = kpt.reshape(B, A, 17, 3).float()
    kxy = (k3[..., :2] * 2.0 + (anchors[:, None, :] - 0.5)) \
        * strides[:, None, None]
    kdec = torch.cat([kxy, torch.sigmoid(k3[..., 2:3])], dim=-1) \
        .reshape(B, A, NK)
    out = torch.cat([cxy, wh, conf, kdec], dim=-1)              # [B, A, 56]
    return out.transpose(1, 2)                                  # [B, 56, A]


def forward_raw(params: dict, x: torch.Tensor, family: str = "v8"):
    """Input [B, S, S, 3] NHWC -> the dense output [B, 56, A] (decode_dense
    of forward_heads), the reference engine's tensor layout."""
    box, cls, kpt = forward_heads(params, x, family)
    return decode_dense(box, cls, kpt, x.shape[1])


def build_model_heads(name: str = "yolov8n-pose", dtype=torch.float32,
                      packed_stem: int = 0):
    """(heads_fn, init_fn): heads_fn(params, images_nhwc) -> forward_heads
    in `dtype`, params prepare_params' tensors (the hot path feeding
    ops.decode.decode_topk); init_fn(seed) -> init_params(seed, name).
    packed_stem: layers.packed_stem's P, where the batch divides by it."""
    family = MODEL_CONFIGS[name].family

    def heads_fn(params, x):
        return forward_heads(params, x.to(dtype), family, packed_stem)

    def init_fn(seed=0):
        return init_params(seed, name)

    return heads_fn, init_fn


def build_model_head_maps(name: str = "yolov8n-pose", dtype=torch.float32,
                          packed_stem: int = 0):
    """head_maps_fn(params, images_nhwc) -> forward_head_maps in `dtype`,
    for the tail-fused decode (DetectorConfig.decode_fusion="tail")."""
    family = MODEL_CONFIGS[name].family

    def head_maps_fn(params, x):
        return forward_head_maps(params, x.to(dtype), family, packed_stem)

    return head_maps_fn


def build_model(name: str = "yolov8n-pose", dtype=torch.float32):
    """(apply_fn, init_fn): apply_fn(params, images_nhwc) -> forward_raw's
    [B, 56, A], computed in `dtype` (the decode in float32), params
    prepare_params' tensors; init_fn(seed) -> init_params(seed, name)."""
    family = MODEL_CONFIGS[name].family

    def apply_fn(params, x):
        return forward_raw(params, x.to(dtype), family)

    def init_fn(seed=0):
        return init_params(seed, name)

    return apply_fn, init_fn

"""YOLOv8-pose and YOLO11-pose forward to the undecoded head outputs,
after posebyte_tpu/models/yolo_pose.py (ModelConfig, the two backbones
and necks, _head_level, forward_heads, make_anchors, _dfl).

The head layout matches the JAX package: box logits [B, A, 64], class
logits [B, A, 1], raw keypoints [B, A, 51], with A the row-major flatten of
the three pyramid levels in stride order (8400 anchors at 640).
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


def _backbone_neck_v8(p, x):
    x = L.conv_block(p, "b0", x, 2)
    x = L.conv_block(p, "b1", x, 2)
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
    x = L.conv_block(p, "b0", x, 2)
    x = L.conv_block(p, "b1", x, 2)
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


def forward_heads(params: dict, x: torch.Tensor, family: str = "v8"):
    """Input [B, S, S, 3] NHWC -> undecoded head outputs
    (box_logits [B, A, 64], cls_logits [B, A, 1], kpt_raw [B, A, 51]),
    computed in x's dtype. params: the port's flat dict of tensors;
    family: "v8" or "v11" (ModelConfig.family)."""
    if family not in _BACKBONES:
        raise ValueError(f"unknown model family {family!r}")
    x = x.permute(0, 3, 1, 2)          # NCHW view of NHWC memory
    feats = _BACKBONES[family](params, x)
    levels = [_head_level(params, i, f, family)
              for i, f in enumerate(feats)]
    return tuple(torch.cat([lv[j] for lv in levels], dim=1)
                 for j in range(3))


@functools.lru_cache(maxsize=8)
def make_anchors(input_size: int = 640, strides=(8, 16, 32)):
    """Anchor centres (grid units) and per-anchor stride, concatenated over
    levels: ([A, 2], [A]) float32 numpy."""
    pts, strs = [], []
    for s in strides:
        n = input_size // s
        xs = np.arange(n, dtype=np.float32) + 0.5
        gy, gx = np.meshgrid(xs, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
        strs.append(np.full((n * n,), s, np.float32))
    return np.concatenate(pts, 0), np.concatenate(strs, 0)


def _dfl(box_logits: torch.Tensor) -> torch.Tensor:
    """Distribution-focal decode: [..., 4, REG_MAX] logits -> [..., 4]
    expected distances (softmax expectation over the bins)."""
    prob = torch.softmax(box_logits.float(), dim=-1)
    bins = torch.arange(REG_MAX, dtype=torch.float32,
                        device=box_logits.device)
    return (prob * bins).sum(dim=-1)

"""YOLOv8-pose forward to the undecoded head outputs, after
posebyte_tpu/models/yolo_pose.py:246-326 (forward_heads, make_anchors,
_dfl).

The head layout matches the JAX package: box logits [B, A, 64], class
logits [B, A, 1], raw keypoints [B, A, 51], with A the row-major flatten of
the three pyramid levels in stride order (8400 anchors at 640).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import layers as L

REG_MAX = 16
NUM_CLASSES = 1
NK = 51          # 17 keypoints * 3


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # "v8" | "v11"


MODEL_CONFIGS = {n: ModelConfig(n, "v8") for n in (
    "yolov8n-pose", "yolov8s-pose", "yolov8m-pose", "yolov8l-pose",
    "yolov8x-pose")}
MODEL_CONFIGS.update({n: ModelConfig(n, "v11") for n in (
    "yolo11n-pose", "yolo11s-pose", "yolo11m-pose", "yolo11l-pose",
    "yolo11x-pose")})


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


def _flat_level(t: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C] (row-major anchors, as the JAX NHWC
    reshape gives them)."""
    B, Cc = t.shape[:2]
    return t.permute(0, 2, 3, 1).reshape(B, -1, Cc)


def _head_level(p, i, x):
    def branch(name):
        k = f"head.{name}.{i}"
        y = L.conv_block(p, f"{k}.1", L.conv_block(p, f"{k}.0", x))
        return _flat_level(L.conv2d(p, f"{k}.2", y))
    return branch("cv2"), branch("cv3"), branch("cv4")


def forward_heads(params: dict, x: torch.Tensor, family: str = "v8"):
    """Input [B, S, S, 3] NHWC -> undecoded head outputs
    (box_logits [B, A, 64], cls_logits [B, A, 1], kpt_raw [B, A, 51]),
    computed in x's dtype. params: the port's flat dict of tensors."""
    if family != "v8":
        raise NotImplementedError(f"the {family} family is not ported yet")
    x = x.permute(0, 3, 1, 2)          # NCHW view of NHWC memory
    feats = _backbone_neck_v8(params, x)
    levels = [_head_level(params, i, f) for i, f in enumerate(feats)]
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

"""YOLOv8 building blocks as plain functions on a flat parameter dict.

Counterparts of posebyte_tpu/models/layers.py (conv_block, bottleneck, c2f,
sppf, upsample2x). Activations are NCHW tensors kept in channels_last
memory, so cuDNN runs its NHWC kernels; weights are OIHW. BatchNorm is
already fused into every conv. Padding is torch-style symmetric k//2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(p: dict, key: str, x: torch.Tensor, stride: int = 1):
    """Conv with bias: p[key + ".w"] [O, I, k, k], p[key + ".b"] [O]."""
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
    while f"{key}.m.{i}.cv1.w" in p:
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

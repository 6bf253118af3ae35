"""The learned Re-ID head, after posebyte_tpu/models/reid_head.py: a 5 x 5
patch sampled around each keypoint (taps 2 px apart), a ReLU MLP shared by
the keypoints (75 -> 32 -> 3), tanh, zero blocks for keypoints with
confidence <= 0.2, and the L2 norm. Its output has the layout of the
pose-colour descriptor (ops/reid.py), so the tracker takes either.

The weights are a dict of float32 tensors w1 [75, 32], b1 [32], w2 [32, 3],
b2 [3]: load_reid_head reads the JAX package's safetensors file (e.g.
assets/reid-head-synthetic.safetensors) with the port's own reader, and
reid_head_from_jax converts the JAX head's arrays. init_reid_head draws a
new head (uniform weights, zero biases, from a torch.Generator) and
save_reid_head writes the file both packages read
(scripts/train_reid.py trains it).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.oks import sum_in_order
from ..ops.reid import REID_DIM, _at
from .weights import read_safetensors, write_safetensors

# Patch geometry: PATCH x PATCH taps, SPACING px apart, centred on each
# keypoint (model-input pixels).
PATCH = 5
SPACING = 2.0
IN_DIM = PATCH * PATCH * 3
HIDDEN = 32

_KEYS = ("w1", "b1", "w2", "b2")


def init_reid_head(seed=0, hidden: int = HIDDEN) -> dict:
    """A new head, after the JAX init_reid_head: w1 [IN_DIM, hidden] and w2
    [hidden, 3] uniform in +-1/sqrt(fan-in), zero biases; float32 CPU
    tensors drawn from `seed` (an int or a torch.Generator)."""
    from .yolo_pose import as_generator
    g = as_generator(seed)
    s1, s2 = 1.0 / np.sqrt(IN_DIM), 1.0 / np.sqrt(hidden)
    return {
        "w1": (torch.rand((IN_DIM, hidden), generator=g) * 2 - 1) * s1,
        "b1": torch.zeros((hidden,)),
        "w2": (torch.rand((hidden, 3), generator=g) * 2 - 1) * s2,
        "b2": torch.zeros((3,)),
    }


def save_reid_head(params: dict, path: str) -> None:
    """Write a head as the JAX package's save_reid_head does (safetensors,
    float32), for either package's load_reid_head."""
    write_safetensors(path, {k: np.asarray(torch.as_tensor(params[k])
                                           .detach().cpu(), np.float32)
                             for k in _KEYS})


@functools.lru_cache(maxsize=None)
def _tap_offsets(device: torch.device) -> torch.Tensor:
    """[PATCH * PATCH, 2] (dx, dy) tap offsets, x fastest, copied to
    `device` once (a copy from pageable host memory waits for the device)."""
    off = (np.arange(PATCH, dtype=np.float32) - (PATCH - 1) / 2.0) * SPACING
    ox, oy = np.meshgrid(off, off)
    offs = np.stack([ox.ravel(), oy.ravel()], -1).astype(np.float32)
    return torch.from_numpy(offs).to(device)


def _sample_patches(image_hwc: torch.Tensor, poses: torch.Tensor,
                    raw_input: bool = False) -> torch.Tensor:
    """Bilinear PATCH x PATCH patch per keypoint: image [..., S, S, 3],
    poses [..., N, 17, 3] -> [..., N, 17, IN_DIM] float32, coordinates
    clamped to [0, S - 1.001], each tap's four corners gathered from the
    image. raw_input flips and scales the sampled values (BGR 0..255 ->
    RGB 0..1)."""
    S = image_hwc.shape[-3]
    xy = poses[..., :2]                                     # [..., N, 17, 2]
    pts = xy[..., None, :] + _tap_offsets(poses.device)   # [..., 17, PP, 2]
    x = pts[..., 0].clamp(0.0, S - 1.001)
    y = pts[..., 1].clamp(0.0, S - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]

    def at(dy, dx):
        return _at(image_hwc, y0 + dy, x0 + dx).float()
    c = (at(0, 0) * (1 - fx) * (1 - fy)
         + at(0, 1) * fx * (1 - fy)
         + at(1, 0) * (1 - fx) * fy
         + at(1, 1) * fx * fy)                              # [..., PP, 3]
    if raw_input:
        c = c.flip(-1) * (1.0 / 255.0)
    return c.reshape(*poses.shape[:-1], IN_DIM)


def apply_reid_head(params: dict, image_hwc: torch.Tensor,
                    poses: torch.Tensor, conf_gate: float = 0.2,
                    raw_input: bool = False) -> torch.Tensor:
    """image [..., S, S, 3] + poses [..., N, 17, 3] -> L2-normalised
    [..., N, 51] (1e-12 inside the square root, the norm floored at
    1e-6); keypoints with confidence <= conf_gate give zero blocks."""
    feats = _sample_patches(image_hwc, poses, raw_input)
    h = torch.relu(feats @ params["w1"] + params["b1"])
    code = torch.tanh(h @ params["w2"] + params["b2"])      # [..., 17, 3]
    code = code * (poses[..., 2] > conf_gate)[..., None]
    emb = code.reshape(*poses.shape[:-2], REID_DIM)
    norm = torch.sqrt(sum_in_order(emb * emb) + 1e-12)[..., None]
    return emb / norm.clamp_min(1e-6)


def reid_head_from_jax(params) -> dict:
    """The JAX head's arrays {w1, b1, w2, b2} -> the port's float32 CPU
    tensors (PosePipeline moves them to its device)."""
    missing = [k for k in _KEYS if k not in params]
    if missing:
        raise ValueError(f"Re-ID head weights lack {missing}")
    out = {k: torch.from_numpy(np.array(params[k], np.float32))
           for k in _KEYS}
    if out["w1"].shape[0] != IN_DIM or out["w2"].shape[1] != 3:
        raise ValueError(f"Re-ID head shapes {tuple(out['w1'].shape)}, "
                         f"{tuple(out['w2'].shape)}: expected [{IN_DIM}, "
                         f"hidden] and [hidden, 3]")
    return out


def load_reid_head(path: str) -> dict:
    """Read a Re-ID head saved by the JAX package (safetensors)."""
    return reid_head_from_jax(read_safetensors(path)[0])

"""Appearance Re-ID: the pose-colour descriptor, the co-visible cosine cost,
its blend into the association cost and the per-track EMA, after
posebyte_tpu/ops/reid.py.

An embedding is [..., 51]: 17 keypoints x 3 channels, keypoint-blocked,
L2-normalised, with zero blocks for keypoints that are not visible. Its
source is either the training-free descriptor here (the letterboxed image
sampled bilinearly at each keypoint) or the learned head
(models/reid_head.py); make_embed_fn picks one. The image functions take
one image [S, S, 3] with poses [N, 17, 3], or a batch of them with one
leading axis on both (the chunk path's K frames).

Every sum whose result reaches the auction is taken in a fixed order, as
Kernel 3 (csrc/tracker_chunk.cu) takes it, so that the card's assignments
equal the plain version's: the energy of a keypoint over its channels
r, g, b; the per-keypoint dot product as explicit products and adds (no
einsum or matmul, whose order is the library's); the 17 keypoints of the
cosine's numerator and norms (ops/oks.py::sum_in_order); the 51
components of an embedding's norm in index order k * 3 + c.
"""
from __future__ import annotations

import torch

from ..core import constants as C
from .oks import sum_in_order

# 17 keypoints x 3 channels, the layout of every appearance source.
REID_DIM = C.NUM_KEYPOINTS * 3


def _batch_index(image: torch.Tensor, like: torch.Tensor):
    """For a batched image [B, S, S, 3], the batch index shaped to
    broadcast against index tensors like `like` [B, ...]; None for one
    image."""
    if image.dim() == 3:
        return None
    return torch.arange(image.shape[0], device=image.device).view(
        -1, *([1] * (like.dim() - 1)))


def _at(image: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor):
    """image[yi, xi] -> [..., 3] (point gathers; a batched image takes
    the batch index from the indices' leading axis)."""
    b = _batch_index(image, yi)
    return image[yi, xi] if b is None else image[b, yi, xi]


def make_embed_fn(reid_params=None, raw_input: bool = False):
    """(image_hwc, poses) -> [..., N, 51] appearance embeddings: the learned
    head (models/reid_head.py) when `reid_params` is given, else the
    pose-colour descriptor. raw_input: the image is the raw letterbox (BGR,
    0..255, possibly uint8); both sources flip and scale the sampled values
    instead of the image. Both sample by index gathers, whatever the
    config's reid_sample_impl: the JAX package's "block" lowering (one-hot
    contractions, a TPU choice) gives the same corner values."""
    if reid_params is not None:
        from ..models.reid_head import apply_reid_head
        return lambda img, poses: apply_reid_head(
            reid_params, img, poses, raw_input=raw_input)
    return lambda img, poses: pose_color_embedding(
        img, poses, raw_input=raw_input)


def pose_color_embedding(image_hwc: torch.Tensor, poses: torch.Tensor,
                         raw_input: bool = False) -> torch.Tensor:
    """Training-free appearance descriptor: image [..., S, S, 3] (0..1
    RGB, or the raw BGR 0..255 letterbox with raw_input) and poses
    [..., N, 17, 3] in its pixel coordinates -> L2-normalised [..., N, 51],
    the image sampled bilinearly at each keypoint (coordinates clamped to
    [0, S - 1.001]); keypoints with confidence <= 0.2 give zero blocks."""
    S = image_hwc.shape[-3]
    x = poses[..., 0].clamp(0.0, S - 1.001)
    y = poses[..., 1].clamp(0.0, S - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0.to(x.dtype))[..., None]
    fy = (y - y0.to(y.dtype))[..., None]
    c00, c01 = _at(image_hwc, y0, x0), _at(image_hwc, y0, x0 + 1)
    c10, c11 = _at(image_hwc, y0 + 1, x0), _at(image_hwc, y0 + 1, x0 + 1)
    c = (c00 * (1 - fx) * (1 - fy)
         + c01 * fx * (1 - fy)
         + c10 * (1 - fx) * fy
         + c11 * fx * fy)                                   # [..., N, 17, 3]
    if raw_input:
        c = c.flip(-1) * (1.0 / 255.0)
    c = c * (poses[..., 2] > 0.2)[..., None]
    emb = c.reshape(*poses.shape[:-2], REID_DIM)
    norm = torch.sqrt(sum_in_order(emb * emb))[..., None]
    return emb / norm.clamp_min(1e-6)


def _energy(e: torch.Tensor) -> torch.Tensor:
    """Per-keypoint energy of [..., 17, 3] blocks, summed r, g, b."""
    return (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1]) \
        + e[..., 2] * e[..., 2]


def cosine_cost_matrix(track_emb: torch.Tensor,
                       det_emb: torch.Tensor) -> torch.Tensor:
    """1 - cosine over the keypoints visible on both sides (block energy
    > 1e-12), [T, 51] x [D, 51] -> [T, D] in [0, 2]; 1.0 for a pair with
    no co-visible keypoint. The norms carry 1e-12 inside the square root
    and their product is floored at 1e-6."""
    t = track_emb.reshape(-1, C.NUM_KEYPOINTS, 3)[:, None]     # [T,1,17,3]
    d = det_emb.reshape(-1, C.NUM_KEYPOINTS, 3)[None]          # [1,D,17,3]
    t_e, d_e = _energy(t), _energy(d)                         # [T,1,17]...
    vis = (t_e > 1e-12) & (d_e > 1e-12)                        # [T,D,17]
    dot = (t[..., 0] * d[..., 0] + t[..., 1] * d[..., 1]) \
        + t[..., 2] * d[..., 2]
    num = sum_in_order(torch.where(vis, dot, 0.0))
    tn = torch.sqrt(sum_in_order(torch.where(vis, t_e, 0.0)) + 1e-12)
    dn = torch.sqrt(sum_in_order(torch.where(vis, d_e, 0.0)) + 1e-12)
    cos = num / (tn * dn).clamp_min(1e-6)
    return torch.where(vis.any(dim=-1), 1.0 - cos, 1.0)


def blend_reid_cost(geom_cost: torch.Tensor, reid_cost: torch.Tensor,
                    weight: float, lock: float = 1e9) -> torch.Tensor:
    """(1 - w) * geometry + w * appearance; entries at or above lock / 2
    (locked or gated pairs) stay as they are."""
    blended = (1.0 - weight) * geom_cost + weight * reid_cost
    return torch.where(geom_cost >= lock / 2, geom_cost, blended)


def ema_update(track_emb: torch.Tensor, det_emb_at_track: torch.Tensor,
               matched: torch.Tensor, alloc: torch.Tensor | None = None,
               gamma: float = 0.9) -> torch.Tensor:
    """Matched tracks' embeddings [T, 51] move toward their detections'
    (gamma * track + (1 - gamma) * detection, renormalised over the 51
    components with the norm floored at 1e-6); tracks in `alloc` take the
    detection's embedding outright."""
    upd = gamma * track_emb + (1.0 - gamma) * det_emb_at_track
    norm = torch.sqrt(sum_in_order(upd * upd))[..., None]
    upd = upd / norm.clamp_min(1e-6)
    out = torch.where(matched[:, None], upd, track_emb)
    if alloc is not None:
        out = torch.where(alloc[:, None], det_emb_at_track, out)
    return out

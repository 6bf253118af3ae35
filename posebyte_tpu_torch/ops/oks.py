"""Object-Keypoint-Similarity matrices for association
(posebyte_tpu/ops/oks.py; reference: gpu_tracker.cu:333-490)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import constants as C

_SIGMAS = np.asarray(C.COCO_SIGMAS, np.float32)
_TORSO = np.asarray(C.TORSO_KEYPOINTS, np.int64)


@functools.lru_cache(maxsize=None)
def _sig_sq(sigma_scale: float, torso: bool, device: torch.device):
    """(sigma_scale * sigma)^2 in float32 on `device`, copied there once."""
    s = _SIGMAS[_TORSO] if torso else _SIGMAS
    return torch.from_numpy((s * np.float32(sigma_scale)) ** 2).to(device)


@functools.lru_cache(maxsize=None)
def torso_index(device: torch.device):
    """The torso keypoint indices on `device`, copied there once."""
    return torch.from_numpy(_TORSO).to(device)


def _masked_area(poses: torch.Tensor, conf_thresh: float = 0.1):
    """Visible-keypoint bbox area per pose [..., 17, 3] -> [...]."""
    xy = poses[..., :2]
    mask = (poses[..., 2] > conf_thresh)[..., None]
    mn = torch.where(mask, xy, 1e9).amin(dim=-2)
    mx = torch.where(mask, xy, -1e9).amax(dim=-2)
    area = (mx[..., 0] - mn[..., 0]) * (mx[..., 1] - mn[..., 1])
    return torch.where(mask[..., 0].any(dim=-1), area.clamp_min(0.0), 0.0)


def oks_matrix(track_poses: torch.Tensor, det_poses: torch.Tensor,
               visibility_threshold: float = C.VISIBILITY_THRESHOLD,
               sigma_scale: float = 2.0, min_scale_sq: float = 1000.0,
               min_count: int = 3) -> torch.Tensor:
    """Visibility-masked OKS: [T, 17, 3] x [D, 17, 3] -> [T, D].

    scale^2 = max(mean of the two visible-keypoint box areas,
    min_scale_sq); per keypoint exp(-d^2 / (2 scale^2 (sigma_scale
    sigma)^2)), averaged over keypoints visible on both sides; fewer than
    min_count of them gives 0."""
    scale_sq = ((_masked_area(track_poses)[:, None]
                 + _masked_area(det_poses)[None, :]) * 0.5
                ).clamp_min(min_scale_sq)                      # [T, D]
    diff = track_poses[:, None, :, :2] - det_poses[None, :, :, :2]
    dist_sq = (diff * diff).sum(dim=-1)                        # [T, D, 17]
    sig = _sig_sq(float(sigma_scale), False, track_poses.device)
    oks_kp = torch.exp(-dist_sq / (2.0 * scale_sq[..., None] * sig))
    vis = ((track_poses[:, None, :, 2] > visibility_threshold)
           & (det_poses[None, :, :, 2] > visibility_threshold))
    count = vis.sum(dim=-1)
    total = torch.where(vis, oks_kp, 0.0).sum(dim=-1)
    return torch.where(count >= min_count, total / count.clamp_min(1), 0.0)


def torso_oks_matrix(track_poses: torch.Tensor, det_poses: torch.Tensor,
                     conf_thresh: float = 0.1, sigma_scale: float = 3.0,
                     scale_sq: float = 10000.0,
                     min_count: int = 2) -> torch.Tensor:
    """Torso-only OKS [T, D] (keypoints 5, 6, 11, 12; kernelTorsoOKS)."""
    torso = torso_index(track_poses.device)
    tp = track_poses[:, torso, :]                              # [T, 4, 3]
    dp = det_poses[:, torso, :]                                # [D, 4, 3]
    diff = tp[:, None, :, :2] - dp[None, :, :, :2]
    dist_sq = (diff * diff).sum(dim=-1)                        # [T, D, 4]
    sig = _sig_sq(float(sigma_scale), True, tp.device)
    oks_kp = torch.exp(-dist_sq / (2.0 * scale_sq * sig))
    vis = ((tp[:, None, :, 2] > conf_thresh)
           & (dp[None, :, :, 2] > conf_thresh))
    count = vis.sum(dim=-1)
    total = torch.where(vis, oks_kp, 0.0).sum(dim=-1)
    return torch.where(count >= min_count, total / count.clamp_min(1), 0.0)

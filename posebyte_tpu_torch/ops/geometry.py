"""Pose geometry: masked keypoint boxes, centres, IoU matrices
(posebyte_tpu/ops/geometry.py; reference: gpu_tracker.cu:196-237 and
:788-857, oks_distance.cu:167-245)."""
from __future__ import annotations

import torch

_BIG = 1e9


def masked_pose_bbox(poses: torch.Tensor, conf_thresh: float = 0.1,
                     min_valid: int = 2):
    """[..., 17, 3] -> (bbox xyxy [..., 4], valid [...]): the box of the
    keypoints above conf_thresh, valid with >= min_valid of them."""
    xy = poses[..., :2]
    mask = (poses[..., 2] > conf_thresh)[..., None]
    mn_xy = torch.where(mask, xy, _BIG).amin(dim=-2)
    mx_xy = torch.where(mask, xy, -_BIG).amax(dim=-2)
    valid = mask[..., 0].sum(dim=-1) >= min_valid
    bbox = torch.cat([mn_xy, mx_xy], dim=-1)
    return torch.where(valid[..., None], bbox, 0.0), valid


def pose_centers(poses: torch.Tensor, conf_thresh: float = 0.1):
    """(cx, cy, w, h) from keypoints; zeros with < 2 visible keypoints."""
    bbox, valid = masked_pose_bbox(poses, conf_thresh)
    cx = (bbox[..., 0] + bbox[..., 2]) * 0.5
    cy = (bbox[..., 1] + bbox[..., 3]) * 0.5
    w = bbox[..., 2] - bbox[..., 0]
    h = bbox[..., 3] - bbox[..., 1]
    centers = torch.stack([cx, cy, w, h], dim=-1)
    return torch.where(valid[..., None], centers, 0.0)


def boxes_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: a [M, 4] x b [N, 4] -> [M, N]."""
    ax1, ay1, ax2, ay2 = (a[:, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[None, :, i] for i in range(4))
    ix = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    iy = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = ix * iy
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return torch.where(union > 0, inter / union.clamp_min(1e-9), 0.0)


def centers_iou_matrix(centers: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU over (cx, cy, w, h) boxes [T, 4] -> [T, T]."""
    half = centers[:, 2:4] * 0.5
    xyxy = torch.cat([centers[:, :2] - half, centers[:, :2] + half], dim=-1)
    return boxes_iou_matrix(xyxy, xyxy)

"""Pose NMS over score-sorted candidates, after posebyte_tpu/ops/nms.py.

Suppression between candidates i and j (gpu_postprocess.cu:134-168):
IoU > iou_threshold, or >= 3 keypoints visible (conf > 0.2) on both and
(OKS > oks_threshold or (OKS > 0.4 and IoU > 0.2)), with OKS scale^2 =
max(area_i, area_j, 32^2) over box areas and falloff
exp(-d^2 / (2 scale^2 4 sigma^2)). Greedy suppression in score order keeps
i when no kept earlier candidate overlaps it.

The keep mask is Kernel 1 on a CUDA tensor (nms_keep_cuda, csrc/nms_keep.cu)
and its plain version (nms_overlap_matrix + _greedy_keep) on a CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.structs import Detections
from . import cuda_lib
from .geometry import boxes_iou_matrix

_SIG4 = np.ascontiguousarray(
    np.float32(4.0) * np.asarray(C.COCO_SIGMAS, np.float32) ** 2)


def nms_overlap_matrix(det: Detections, iou_threshold: float,
                       oks_threshold: float) -> torch.Tensor:
    """Symmetric [N, N] bool overlap mask (kernelComputeNMSMask), with the
    kernel's arithmetic: keypoints summed in index order, denominator
    (2 scale^2) * (4 sigma^2)."""
    N = det.capacity
    boxes, poses = det.boxes, det.poses
    iou = boxes_iou_matrix(boxes, boxes)                        # [N, N]
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    scale2 = 2.0 * torch.maximum(area[:, None],
                                 area[None, :]).clamp_min(32.0 * 32.0)
    sig4 = torch.from_numpy(_SIG4).to(poses.device)
    oks_sum = torch.zeros((N, N), dtype=torch.float32, device=poses.device)
    count = torch.zeros((N, N), dtype=torch.int32, device=poses.device)
    for q in range(C.NUM_KEYPOINTS):
        dx = poses[:, None, q, 0] - poses[None, :, q, 0]
        dy = poses[:, None, q, 1] - poses[None, :, q, 1]
        dist_sq = dx * dx + dy * dy
        oks_kp = torch.exp(-dist_sq / (scale2 * sig4[q]))
        vis = (poses[:, None, q, 2] > 0.2) & (poses[None, :, q, 2] > 0.2)
        oks_sum = oks_sum + torch.where(vis, oks_kp, 0.0)
        count = count + vis.to(torch.int32)
    oks = torch.where(count >= 3, oks_sum / count.clamp_min(1), 0.0)
    overlap = (iou > iou_threshold) | (
        (count >= 3) & ((oks > oks_threshold) | ((oks > 0.4) & (iou > 0.2))))
    pair_ok = det.valid[:, None] & det.valid[None, :]
    eye = torch.eye(N, dtype=torch.bool, device=poses.device)
    return overlap & pair_ok & ~eye


def _greedy_keep(overlap_sorted: torch.Tensor,
                 valid_sorted: torch.Tensor) -> torch.Tensor:
    """Exact greedy keep mask in score order, by Jacobi fixed point: each
    sweep keeps i unless a kept earlier candidate overlaps it; the sweeps
    reach the greedy solution after (longest suppression chain + 1)."""
    N = overlap_sorted.shape[0]
    earlier = torch.ones((N, N), dtype=torch.bool,
                         device=overlap_sorted.device).triu(diagonal=1)
    dom = overlap_sorted & earlier          # dom[j, i]: j earlier, overlaps
    keep = valid_sorted
    for _ in range(N):
        new = valid_sorted & ~(dom & keep[:, None]).any(dim=0)
        done = torch.equal(new, keep)
        keep = new
        if done:
            break
    return keep


def nms_keep_plain(poses: torch.Tensor, boxes: torch.Tensor,
                   valid: torch.Tensor, iou_threshold: float,
                   oks_threshold: float) -> torch.Tensor:
    """Plain PyTorch keep mask over score-sorted poses [N, 17, 3],
    boxes [N, 4], valid [N] -> keep [N] bool."""
    det = Detections(poses=poses, boxes=boxes,
                     scores=torch.zeros_like(boxes[:, 0]), valid=valid)
    return _greedy_keep(nms_overlap_matrix(det, iou_threshold, oks_threshold),
                        valid)


def nms_keep_cuda(poses: torch.Tensor, boxes: torch.Tensor,
                  valid: torch.Tensor, iou_threshold: float,
                  oks_threshold: float) -> torch.Tensor:
    """Kernel 1 on CUDA tensors: poses [B, N, 17, 3] f32, boxes [B, N, 4]
    f32, valid [B, N] bool (the batch axis may be left out) -> keep
    [B, N] bool. Raises on a bad input or a launch error."""
    unbatched = poses.dim() == 3
    if unbatched:
        poses, boxes, valid = poses[None], boxes[None], valid[None]
    if not (poses.is_cuda and boxes.device == poses.device
            and valid.device == poses.device):
        raise ValueError("nms_keep_cuda: all inputs must be on one CUDA "
                         "device")
    if poses.dtype != torch.float32 or boxes.dtype != torch.float32 \
            or valid.dtype != torch.bool:
        raise TypeError("nms_keep_cuda: poses/boxes float32, valid bool")
    B, N = valid.shape
    lib = cuda_lib.load()
    if poses.shape != (B, N, C.NUM_KEYPOINTS, 3) or boxes.shape != (B, N, 4) \
            or not 0 < N <= lib.posebyte_nms_keep_max_n():
        raise ValueError(f"nms_keep_cuda: bad shapes {tuple(poses.shape)}, "
                         f"{tuple(boxes.shape)}, {tuple(valid.shape)}")
    if not (poses.is_contiguous() and boxes.is_contiguous()
            and valid.is_contiguous()):
        raise ValueError("nms_keep_cuda: inputs must be contiguous")
    keep = torch.empty((B, N), dtype=torch.bool, device=poses.device)
    with torch.cuda.device(poses.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.posebyte_nms_keep(
            poses.data_ptr(), boxes.data_ptr(), valid.data_ptr(),
            keep.data_ptr(), B, N, float(iou_threshold),
            float(oks_threshold), _SIG4.ctypes.data, stream)
    cuda_lib.check(status, "nms_keep")
    nms_keep_cuda.launches += 1
    return keep[0] if unbatched else keep


nms_keep_cuda.launches = 0


def nms_keep(poses: torch.Tensor, boxes: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float, oks_threshold: float) -> torch.Tensor:
    """Keep mask [N] over score-sorted candidates: Kernel 1 for a CUDA
    tensor, the plain version for a CPU tensor."""
    if poses.is_cuda:
        return nms_keep_cuda(poses, boxes, valid, iou_threshold,
                             oks_threshold)
    if poses.device.type != "cpu":
        raise ValueError(f"nms_keep: unsupported device {poses.device}")
    return nms_keep_plain(poses, boxes, valid, iou_threshold, oks_threshold)


def pose_nms(det: Detections, iou_threshold: float = 0.55,
             oks_threshold: float = 0.55,
             max_keep: int = C.DEFAULT_MAX_DETECTIONS) -> Detections:
    """Greedy NMS over a score-sorted Detections (invalid entries at the
    tail, as decode_topk gives them) -> a compacted, score-descending
    Detections of capacity max_keep (reference: kernelApplyNMSMask ->
    kernelCompactDetections, gpu_postprocess.cu:178-313).

    Survivors are compacted by a cumulative count and an index gather: the
    m-th kept candidate is the first rank whose running count reaches
    m + 1. Empty slots are zero."""
    keep = nms_keep(det.poses, det.boxes, det.valid, iou_threshold,
                    oks_threshold)
    N = det.capacity
    csum = torch.cumsum(keep.to(torch.int64), dim=0)           # [N]
    slots = torch.arange(1, max_keep + 1, dtype=torch.int64,
                         device=csum.device)
    src = torch.searchsorted(csum, slots).clamp_max(N - 1)     # [max_keep]
    out_valid = slots <= csum[-1]
    v = out_valid[:, None]
    return Detections(
        poses=torch.where(v[..., None], det.poses[src], 0.0),
        boxes=torch.where(v, det.boxes[src], 0.0),
        scores=torch.where(out_valid, det.scores[src], 0.0),
        valid=out_valid,
    )

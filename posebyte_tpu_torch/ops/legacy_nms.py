"""Legacy pose NMS (the reference's CPU postprocess path), after
posebyte_tpu/ops/legacy_nms.py (reference: NMSCuda::apply,
src/cuda/nms.cu:142-306), which the engine's host entry points detect and
detect_batch use (yolo_pose_engine.cpp:765-775).

Suppress j (lower score) against kept i when any of
  1. IoU > 0.55
  2. OKS > 0.5 (the reference hardcodes 0.5 and ignores its oks_threshold
     parameter, nms.cu:242; the parameter is accepted and ignored here too)
  3. IoU > 0.2 and OKS > 0.4
  4. centre distance < 0.3 * max(w_i, h_i, 32) and OKS > 0.15, with the
     keeper's (row i's) box: the rule is directional.
OKS takes the larger of the two visible-keypoint bbox areas (floor 32^2),
needs >= 3 visible keypoints on each side, k = 2 sigma; its keypoint sum
runs in index order (ops/oks.py::sum_in_order).

The pairwise suppression matrix is built in one broadcast pass and the
greedy keep set comes from the Jacobi fixed point of ops/nms.py's
_greedy_keep, in PyTorch on either device. The JAX package runs this pass
as plain XLA, not through its Pallas kernel, so it is no fallback from
Kernel 1: Kernel 1 computes ops/nms.py's rules, not these.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.structs import Detections
from .geometry import boxes_iou_matrix
from .nms import _greedy_keep
from .oks import sum_in_order

_SIG2 = np.asarray(C.COCO_SIGMAS, np.float32) ** 2


def legacy_oks_pair_matrix(poses: torch.Tensor) -> torch.Tensor:
    """Symmetric [N, N] OKS matrix with the legacy path's semantics
    (reference: the computeOKS lambda, nms.cu:185-236) for poses
    [N, 17, 3]."""
    xy = poses[..., :2]
    vis = poses[..., 2] > 0.2                                   # [N, 17]
    mn = torch.where(vis[..., None], xy, 1e9).amin(dim=-2)
    mx = torch.where(vis[..., None], xy, -1e9).amax(dim=-2)
    count = vis.sum(dim=-1)                                     # [N]
    area = torch.where(count >= 1,
                       (mx[..., 0] - mn[..., 0]) * (mx[..., 1] - mn[..., 1]),
                       0.0)
    scale_sq = torch.maximum(area[:, None], area[None, :]) \
        .clamp_min(32.0 * 32.0)                                 # [N, N]
    diff = xy[:, None] - xy[None, :]                            # [N, N, 17, 2]
    dist_sq = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    sig2 = torch.from_numpy(_SIG2).to(poses.device)
    oks_kp = torch.exp(-dist_sq / (2.0 * scale_sq[..., None] * 4.0 * sig2))
    covis = vis[:, None, :] & vis[None, :, :]
    n_pair = covis.sum(dim=-1)
    oks = torch.where(n_pair >= 3,
                      sum_in_order(torch.where(covis, oks_kp, 0.0))
                      / n_pair.clamp_min(1), 0.0)
    both = (count >= 3)[:, None] & (count >= 3)[None, :]
    return torch.where(both, oks, 0.0)


def legacy_pose_nms(det: Detections, oks_threshold: float = 0.5,
                    score_threshold: float = 0.0,
                    max_keep: int = C.DEFAULT_MAX_DETECTIONS) -> Detections:
    """Legacy-path NMS over one image's padded Detections [N]: the kept
    candidates in descending score order (a stable sort, ties to the lower
    index), compacted into max_keep rows, the rest zero.

    `oks_threshold` is accepted and, as in the reference, not applied (the
    hardcoded 0.5 is, nms.cu:242)."""
    del oks_threshold                     # the reference's quirk
    N = det.capacity
    dev = det.scores.device
    valid = det.valid & (det.scores >= score_threshold)
    boxes = det.boxes
    iou = boxes_iou_matrix(boxes, boxes)
    oks = legacy_oks_pair_matrix(det.poses)
    cx = (boxes[:, 0] + boxes[:, 2]) * 0.5
    cy = (boxes[:, 1] + boxes[:, 3]) * 0.5
    dist = torch.sqrt((cx[:, None] - cx[None, :]) ** 2
                      + (cy[:, None] - cy[None, :]) ** 2)
    # the keeper's scale: row i is the higher-scoring detection
    scale_i = torch.maximum(boxes[:, 2] - boxes[:, 0],
                            boxes[:, 3] - boxes[:, 1]).clamp_min(32.0)[:, None]
    suppress = ((iou > 0.55) | (oks > 0.5) | ((iou > 0.2) & (oks > 0.4))
                | ((dist / scale_i < 0.3) & (oks > 0.15)))
    eye = torch.eye(N, dtype=torch.bool, device=dev)
    suppress = suppress & valid[:, None] & valid[None, :] & ~eye

    order = torch.argsort(-torch.where(valid, det.scores, -torch.inf),
                          stable=True)
    # rule 4 is directional: rows and columns take the same permutation
    keep_ranked = _greedy_keep(suppress[order][:, order], valid[order])

    pos = torch.cumsum(keep_ranked, dim=0) - 1
    dest = torch.where(keep_ranked & (pos < max_keep), pos, max_keep)

    def scatter(src):
        out = src.new_zeros((max_keep + 1,) + src.shape[1:])
        return out.index_put_((dest,), src[order])[:max_keep]

    num_kept = keep_ranked.sum()
    return Detections(
        poses=scatter(det.poses), boxes=scatter(det.boxes),
        scores=scatter(det.scores),
        valid=torch.arange(max_keep, device=dev)
        < torch.clamp(num_kept, max=max_keep))

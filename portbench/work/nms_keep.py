"""The work that pose NMS's keep mask needs on one call's candidates
(Kernel 1, ops/nms.py): the algorithm's, not a kernel's.

Bytes: the candidates' poses [B, N, 17, 3] and boxes [B, N, 4] float32
and valid [B, N] read once, the keep mask [B, N] written once.
Operations, float32, for each pair of valid candidates of a frame (each
pair once): the box IoU, 12; where the IoU alone does not decide
(IoU <= the threshold), 8 for each keypoint visible (conf > 0.2) in both
(difference, square and add for x and y, scale, exp, sum). The greedy
pass over the overlap mask is counted as one operation a pair."""
from __future__ import annotations

import numpy as np


def _iou(boxes: np.ndarray) -> np.ndarray:
    x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area[:, None] + area[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def work(poses: np.ndarray, boxes: np.ndarray, valid: np.ndarray,
         iou_threshold: float):
    """(bytes, float32 operations) of one keep mask over poses [B, N, 17,
    3], boxes [B, N, 4], valid [B, N] (one frame: B = 1)."""
    poses = poses.reshape(-1, *poses.shape[-3:])
    boxes = boxes.reshape(-1, *boxes.shape[-2:])
    valid = valid.reshape(-1, valid.shape[-1]).astype(bool)
    nbytes = poses.size * 4 + boxes.size * 4 + 2 * valid.size
    ops = 0
    for p, b, v in zip(poses, boxes, valid):
        idx = np.nonzero(v)[0]
        p, b = p[idx], b[idx]
        pair = np.triu(np.ones((len(idx), len(idx)), bool), 1)
        vis = p[..., 2] > 0.2
        covis = (vis[:, None, :] & vis[None, :, :]).sum(-1)
        need_oks = pair & (_iou(b) <= iou_threshold)
        ops += 13 * int(pair.sum()) + 8 * int((covis * need_oks).sum())
    return nbytes, ops

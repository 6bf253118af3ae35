"""Oracle detector: the exact inverse of the decode path, after
posebyte_tpu/models/oracle.py.

encode_oracle_head turns known poses into raw YOLO-pose head tensors (box
DFL logits, class logits, keypoint regressions) that ops.decode.decode_topk
and ops.nms.pose_nms give back. Injected as a `heads_fn` into PosePipeline
or a stream server, with those tensors as its params, it checks the whole
chain after the detector (letterbox geometry, decode, NMS, tracking,
output extraction and un-letterboxing) against a known answer, without
trained weights.
"""
from __future__ import annotations

import numpy as np

from .yolo_pose import REG_MAX, make_anchors

NUM_KPT = 17


def _logit(p: float) -> float:
    p = min(max(p, 1e-6), 1.0 - 1e-6)
    return float(np.log(p / (1.0 - p)))


def encode_oracle_head(poses: np.ndarray, boxes: np.ndarray,
                       scores: np.ndarray, input_size: int) -> dict:
    """Poses [P, 17, 3], boxes [P, 4] xyxy and scores [P] in letterbox
    (model input) coordinates -> {"box": [A, 4 * REG_MAX], "cls": [A, 1],
    "kpt": [A, 51]} float32 numpy, from which decode_topk recovers each
    entry. Each pose takes the stride-8 anchor cell holding its box centre
    (the next free cell of its row on a collision); a box distance is a
    two-bin distribution whose softmax expectation is the distance, clipped
    to the DFL support [0, REG_MAX - 1] in stride units."""
    anchors, strides = make_anchors(input_size)       # [A, 2] grid, [A]
    A = anchors.shape[0]
    box = np.zeros((A, 4 * REG_MAX), np.float32)
    cls = np.full((A, 1), -20.0, np.float32)          # sigmoid ~ 0
    kpt = np.zeros((A, NUM_KPT * 3), np.float32)
    kpt[:, 2::3] = -20.0                               # keypoint conf ~ 0

    n0 = input_size // 8                               # stride-8 grid
    taken = set()
    for p in range(len(poses)):
        x1, y1, x2, y2 = (float(v) for v in boxes[p])
        cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        ix = int(np.clip(round(cx / 8.0 - 0.5), 0, n0 - 1))
        iy = int(np.clip(round(cy / 8.0 - 0.5), 0, n0 - 1))
        while (iy * n0 + ix) in taken:
            ix = (ix + 1) % n0
        a = iy * n0 + ix
        taken.add(a)
        ax, ay = anchors[a]
        s = strides[a]

        dists = np.clip([ax - x1 / s, ay - y1 / s,
                         x2 / s - ax, y2 / s - ay], 0.0, REG_MAX - 1.0)
        for f, d in enumerate(dists):
            lo = int(np.floor(d))
            hi = min(lo + 1, REG_MAX - 1)
            fr = float(d - lo)
            probs = np.full(REG_MAX, 1e-12, np.float64)
            probs[lo] += 1.0 - fr
            probs[hi] += fr
            box[a, f * REG_MAX:(f + 1) * REG_MAX] = np.log(probs)

        cls[a, 0] = _logit(float(scores[p]))

        # keypoints: xy = (raw * 2 + (anchor - 0.5)) * stride (the decode)
        raw_xy = (poses[p, :, :2] / s - (np.asarray([ax, ay]) - 0.5)) / 2.0
        kpt[a, 0::3] = raw_xy[:, 0]
        kpt[a, 1::3] = raw_xy[:, 1]
        kpt[a, 2::3] = [_logit(float(c)) for c in poses[p, :, 2]]

    return {"box": box, "cls": cls, "kpt": kpt}


def make_oracle_heads():
    """heads_fn(params, images) that ignores the pixels and returns the
    params' head tensors expanded over the images' batch."""

    def heads_fn(params, images):
        B = images.shape[0]
        return tuple(params[k].expand(B, *params[k].shape)
                     for k in ("box", "cls", "kpt"))

    return heads_fn

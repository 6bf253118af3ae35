"""The work of the tracker over one chunk (Kernel 3, ops/tracker_chunk.py):
the algorithm's, counted from the chunk's inputs and outputs.

Bytes: the detections (poses [K, D, 17, 3], scores [K, D] float32, valid
[K, D]) and the tracker state of T slots read once, the per-frame outputs
(ids, scores, poses, boxes, emit, num_active) and the final state written
once. Operations, float32, per frame: for each pair of a track active at
the frame's start and a valid detection, ~30 for the gate and 8 per
keypoint for the full-body OKS (17) and the torso OKS (4); for each pair
of active tracks, ~20 for the duplicate test. The tracks active at a
frame's start are those the previous frame ended with (num_active); the
chunk's first frame takes the state's own count."""
from __future__ import annotations

import numpy as np

STATE_BYTES_PER_SLOT = (51 + 34 + 1 + 5) * 4 + 1


def work(valid: np.ndarray, num_active: np.ndarray, active_in: int, T: int,
         D: int):
    """(bytes, float32 operations): valid [K, D] bool, num_active [K] the
    tracks active after each frame, active_in those before the first."""
    K = valid.shape[0]
    state = T * STATE_BYTES_PER_SLOT + 8 + 4 * D
    det_in = K * D * (51 * 4 + 4 + 1)
    out = K * D * (4 + 4 + 51 * 4 + 4 * 4 + 1) + 4 * K
    nbytes = 2 * state + det_in + out
    before = np.concatenate([[active_in], num_active[:-1]]).astype(np.int64)
    nv = valid.sum(-1).astype(np.int64)
    ops = int(((30 + 8 * (17 + 4)) * before * nv + 20 * before * before)
              .sum())
    return nbytes, ops

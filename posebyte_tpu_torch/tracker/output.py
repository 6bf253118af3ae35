"""Per-frame track output, after posebyte_tpu/tracker/output.py:34-67
(reference: GPUTracker::getActiveTracks, gpu_tracker.cu:1559-1639).

The filtering (tentative below min_hits, lost) happens on the device, so
one small tensor set crosses to the host per frame.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import constants as C
from ..core.config import TrackerConfig
from ..core.structs import TrackerState


@dataclasses.dataclass
class TrackOutput:
    """Host-side track record (reference: TrackOutput, types.h:169-174)."""
    track_id: int
    score: float
    bbox: np.ndarray        # [4] xyxy
    keypoints: np.ndarray   # [17, 3]


def extract_outputs_device(state: TrackerState, det_scores: torch.Tensor,
                           config: TrackerConfig = TrackerConfig()):
    """-> (ids [D], scores [D], poses [D, 17, 3], boxes [D, 4], emit [D]),
    aligned with the detection slots; boxes are the keypoints (conf > 0.2)
    padded by 10% per side."""
    slot = state.det_track_slot
    safe = slot.clamp(0, config.max_tracks - 1).long()
    st = state.states[safe]
    emit = (slot >= 0) & state.active[safe]
    emit &= ~((st == C.TRACK_STATE_TENTATIVE)
              & (state.hits[safe] < config.min_hits))
    emit &= st != C.TRACK_STATE_LOST

    poses = state.poses[safe]
    ids = torch.where(emit, state.ids[safe], -1)
    scores = torch.where(emit, det_scores, 0.0)

    xy = poses[..., :2]
    mask = (poses[..., 2] > 0.2)[..., None]
    mn = torch.where(mask, xy, 1e9).amin(dim=-2)
    mx = torch.where(mask, xy, -1e9).amax(dim=-2)
    pad = (mx - mn) * 0.1
    boxes = torch.cat([mn - pad, mx + pad], dim=-1)
    boxes = torch.where(mask.any(dim=-2), boxes, 0.0)
    return ids, scores, poses, boxes, emit

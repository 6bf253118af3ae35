"""Per-frame track output, after posebyte_tpu/tracker/output.py
(reference: GPUTracker::getActiveTracks, gpu_tracker.cu:1559-1639).

The filtering (tentative below min_hits, lost) happens on the device, and
the outputs are packed there into one int32 tensor (pack_outputs), so that
one copy crosses to the host.
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


def pack_outputs(outs: dict) -> torch.Tensor:
    """Track outputs with leading axes [..., D] -> one int32 tensor [...,
    D, 59] on their device (floats by their bits): ids, scores, the poses'
    51 values, the boxes' 4, emit, and num_active repeated over D. A step
    copies it to the host in one transfer; unpack_outputs reads it."""
    i32 = torch.int32
    ids = outs["ids"].to(i32)
    return torch.cat([
        ids[..., None],
        outs["scores"].float().view(i32)[..., None],
        outs["poses"].float().flatten(-2).view(i32),
        outs["boxes"].float().view(i32),
        outs["emit"].to(i32)[..., None],
        outs["num_active"].to(i32)[..., None, None].expand_as(
            ids[..., None])], dim=-1)


def unpack_outputs(packed: np.ndarray) -> dict:
    """pack_outputs' host copy [..., D, 59] -> numpy views: ids, scores,
    poses [..., D, 17, 3], boxes [..., D, 4], emit (bool), num_active [...]
    (int32)."""
    f32 = packed.view(np.float32)
    return {"ids": packed[..., 0], "scores": f32[..., 1],
            "poses": f32[..., 2:53].reshape(*packed.shape[:-1], 17, 3),
            "boxes": f32[..., 53:57], "emit": packed[..., 57] != 0,
            "num_active": packed[..., 0, 58]}


def get_active_tracks(state: TrackerState, det_scores: torch.Tensor,
                      config: TrackerConfig = TrackerConfig()) -> list:
    """The state's emitted tracks as a host list of TrackOutput, in the
    coordinates the state holds (the visualisation's device-to-host
    boundary): one packed copy to the host."""
    ids, scores, poses, boxes, emit = extract_outputs_device(
        state, torch.as_tensor(det_scores, device=state.poses.device),
        config)
    host = unpack_outputs(pack_outputs({
        "ids": ids, "scores": scores, "poses": poses, "boxes": boxes,
        "emit": emit, "num_active": state.active.sum()}).cpu().numpy())
    return [TrackOutput(track_id=int(host["ids"][d]),
                        score=float(host["scores"][d]),
                        bbox=host["boxes"][d].copy(),
                        keypoints=host["poses"][d].copy())
            for d in np.flatnonzero(host["emit"])]

"""Tracker debug introspection, after posebyte_tpu/tracker/debug.py
(reference: GPUPostprocess::debugDumpDetections and getRawDetections,
gpu_postprocess.cu:478-534; KalmanFilterCUDA::getState,
kalman_filter.cu:632-640).

tracker_step_debug runs the association stages of a tracker step again and
returns every intermediate (gate masks, cost matrices, each tier's
assignments) as numpy arrays under the JAX package's keys: the
counterpart of dumping the reference's device buffers. Its three tiers go
through tracker.step._tier_assign, so through Kernel 2 on a CUDA tensor
(ops.assignment.auction) and its plain version on a CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.config import TrackerConfig
from ..core.structs import Detections, TrackerState
from ..ops.gating import spatial_gate
from ..ops.geometry import pose_centers
from ..ops.kalman import cv_predict
from ..ops.oks import oks_matrix, torso_oks_matrix
from .step import LOCK_COST, _lock, _tier_assign


def tracker_step_debug(state: TrackerState, det: Detections,
                       config: TrackerConfig = TrackerConfig()) -> dict:
    """The association-stage intermediates of one step (the cv motion
    model's prediction, both gates, the three tiers' costs and merged
    assignments), copied to the host."""
    act = state.active
    states = state.states
    with torch.inference_mode():
        predicted, velocities = cv_predict(state.poses, state.velocities,
                                           act, states)
        track_centers = pose_centers(predicted)
        det_centers = pose_centers(det.poses)
        gate = spatial_gate(track_centers, det_centers, velocities, act,
                            states, config.gate_threshold) \
            & det.valid[None, :]

        non_lost = act & (states != C.TRACK_STATE_LOST)
        gate1 = gate & non_lost[:, None]
        oks1 = oks_matrix(predicted, det.poses, config.visibility_threshold)
        cost1 = torch.where(gate1, 1.0 - oks1, LOCK_COST)
        T, D = cost1.shape
        none_t = torch.full((T,), -1, dtype=torch.int32, device=act.device)
        none_d = torch.full((D,), -1, dtype=torch.int32, device=act.device)
        row1, col1 = _tier_assign(cost1, act, none_t, none_d)

        torso = torso_oks_matrix(predicted, det.poses)
        cost2 = _lock(torch.where(gate1, 1.0 - torso, LOCK_COST), row1, col1)
        row2, col2 = _tier_assign(cost2, act, row1, col1)

        lost_gate = spatial_gate(track_centers, det_centers, velocities, act,
                                 states,
                                 config.gate_threshold * C.LOST_GATE_SCALE)
        only_lost = act & (states == C.TRACK_STATE_LOST)
        lost_gate = lost_gate & only_lost[:, None] & det.valid[None, :]
        oks3 = oks_matrix(predicted, det.poses, 0.2)
        cost3 = _lock(torch.where(lost_gate, 1.0 - oks3, LOCK_COST), row2,
                      col2)
        row3, col3 = _tier_assign(cost3, act, row2, col2)

    out = {
        "predicted_poses": predicted,
        "track_centers": track_centers,
        "det_centers": det_centers,
        "gate_mask": gate,
        "lost_gate_mask": lost_gate,
        "oks_matrix": oks1,
        "torso_oks_matrix": torso,
        "cost_high": cost1,
        "cost_low": cost2,
        "cost_lost": cost3,
        "row_assign_high": row1, "col_assign_high": col1,
        "row_assign_low": row2, "col_assign_low": col2,
        "row_assign_final": row3, "col_assign_final": col3,
    }
    return {k: v.cpu().numpy() for k, v in out.items()}


def dump_detections(det: Detections, max_dump: int = 3) -> str:
    """Readable dump of the first `max_dump` valid detections
    (debugDumpDetections), the JAX package's string character for
    character."""
    poses, boxes, scores, valid = (getattr(det, f).cpu().numpy()
                                   for f in ("poses", "boxes", "scores",
                                             "valid"))
    lines = [f"=== {int(valid.sum())} detections ==="]
    shown = 0
    for i in range(len(scores)):
        if not valid[i] or shown >= max_dump:
            continue
        shown += 1
        lines.append(f"det[{i}] score={scores[i]:.3f} "
                     f"bbox=({boxes[i][0]:.1f},{boxes[i][1]:.1f},"
                     f"{boxes[i][2]:.1f},{boxes[i][3]:.1f})")
        for k, name in enumerate(C.KEYPOINT_NAMES):
            x, y, c = poses[i, k]
            lines.append(f"    {name:15s} ({x:7.1f},{y:7.1f}) conf={c:.2f}")
    return "\n".join(lines)


def get_track_states(state: TrackerState) -> list:
    """Host view of the live slots (GPUTrackState, gpu_tracker.h:44-50):
    one dict per active slot with slot, track_id, state, hits, age and
    last_frame."""
    ids, st, hits, ages, last, active = (
        np.asarray(t.cpu()) for t in (state.ids, state.states, state.hits,
                                      state.ages, state.last_frame,
                                      state.active))
    return [{"slot": i, "track_id": int(ids[i]), "state": int(st[i]),
             "hits": int(hits[i]), "age": int(ages[i]),
             "last_frame": int(last[i])}
            for i in range(len(ids)) if active[i]]

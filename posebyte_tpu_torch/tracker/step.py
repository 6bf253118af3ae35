"""The tracker step: the two-tier ByteTrack pose update, after
posebyte_tpu/tracker/step.py:90-297 (reference: GPUTracker::update,
gpu_tracker.cu:1057-1557), with either motion model (config.motion_model:
"cv", the constant-gain filter, or "kalman136", the third-order filter of
ops/kalman.py::Kalman136 over kf_mean / kf_cov) and the optional
appearance Re-ID term (ops/reid.py).

Stages: 1 predict (kalman136: every slot's filter, the prediction and the
gating velocities from it), 2 spatial gating, 3 high-confidence tier
(full OKS, non-lost tracks), 4 torso-OKS tier, 5 lost-track recovery,
6 update matched (kalman136: the filter's update, poses from its mean),
7 age unmatched, 8 new tracks by deterministic prefix-sum slot allocation
(ids in detection order; kalman136 initiates their filters), 9 duplicate
suppression by the dominance rule. Each of the three tiers runs one
auction (ops.assignment.auction): Kernel 2 on a CUDA tensor, the plain
version on a CPU tensor. With Re-ID the co-visible cosine cost of the
tracks' and the detections' embeddings is blended into tiers 1 (stage 3)
and 3 (stage 5), matched tracks' embeddings follow their detections by EMA
(stage 6) and new tracks take their detection's (stage 8).
"""
from __future__ import annotations

import torch

from ..core import constants as C
from ..core.config import TrackerConfig
from ..core.structs import Detections, KalmanState136, TrackerState, \
    scatter_rows
from ..ops.assignment import auction as _auction
from ..ops.gating import spatial_gate
from ..ops.geometry import centers_iou_matrix, pose_centers
from ..ops.kalman import Kalman136, cv_predict, cv_update
from ..ops.oks import oks_matrix, torso_oks_matrix
from ..ops.reid import blend_reid_cost, cosine_cost_matrix, ema_update

LOCK_COST = 1e9


def _tier_assign(cost, active, row_assign, col_assign):
    """One auction tier, merged so that earlier assignments win
    (kernelMergeAssignments, gpu_tracker.cu:575-588)."""
    new_row, new_col = _auction(cost, active)
    return (torch.where(row_assign >= 0, row_assign, new_row),
            torch.where(col_assign >= 0, col_assign, new_col))


def _lock(cost, row_assign, col_assign):
    """Matched rows and columns to LOCK_COST (kernelLockMatchedPairs)."""
    locked = (row_assign >= 0)[:, None] | (col_assign >= 0)[None, :]
    return torch.where(locked, LOCK_COST, cost)


def tracker_step(state: TrackerState, det: Detections,
                 config: TrackerConfig = TrackerConfig(),
                 det_embeddings: torch.Tensor | None = None):
    """One tracking frame: (state, detections) -> (new state, aux).

    `det` is the padded, score-descending output of pose_nms with capacity
    config.max_detections. det_embeddings: optional [D, 51] appearance
    embeddings of the detections (ops/reid.py); Re-ID runs when they are
    given and config.reid_weight > 0, as in the JAX package. The input
    state is not modified."""
    use_kf136 = config.motion_model == "kalman136"
    T, D = config.max_tracks, config.max_detections
    dev = state.poses.device
    i32 = dict(dtype=torch.int32, device=dev)
    frame = state.frame + 1
    act = state.active
    states = state.states
    dvalid = det.valid
    num_active_in = act.sum()

    # ---- 1: predict ------------------------------------------------------
    if use_kf136:
        kf = Kalman136.predict(KalmanState136(state.kf_mean, state.kf_cov),
                               config.accel_memory, config.jerk_memory)
        kf_split = kf.mean.reshape(T, C.NUM_KEYPOINTS, 8)
        velocities = kf_split[..., 2:4]
        predicted = torch.cat(
            [torch.where(act[:, None, None], kf_split[..., 0:2],
                         state.poses[..., :2]),
             state.poses[..., 2:3]], dim=-1)
    else:
        predicted, velocities = cv_predict(state.poses, state.velocities,
                                           act, states)

    # ---- 2: spatial gating -----------------------------------------------
    track_centers = pose_centers(predicted)                     # [T, 4]
    det_centers = pose_centers(det.poses)                       # [D, 4]
    gate = spatial_gate(track_centers, det_centers, velocities, act, states,
                        config.gate_threshold) & dvalid[None, :]
    use_reid = config.reid_weight > 0.0 and det_embeddings is not None
    if use_reid:
        reid_cost = cosine_cost_matrix(state.embeddings, det_embeddings)

    # ---- 3: high-confidence tier (full OKS, non-lost tracks) -------------
    non_lost = act & (states != C.TRACK_STATE_LOST)
    gate1 = gate & non_lost[:, None]
    oks1 = oks_matrix(predicted, det.poses, config.visibility_threshold)
    cost = torch.where(gate1, 1.0 - oks1, LOCK_COST)
    if use_reid:
        cost = blend_reid_cost(cost, reid_cost, config.reid_weight)
    row_assign, col_assign = _tier_assign(
        cost, act, torch.full((T,), -1, **i32), torch.full((D,), -1, **i32))

    # ---- 4: torso-OKS tier -----------------------------------------------
    if config.torso_tier:
        cost2 = torch.where(gate1,
                            1.0 - torso_oks_matrix(predicted, det.poses),
                            LOCK_COST)
        cost2 = _lock(cost2, row_assign, col_assign)
        row_assign, col_assign = _tier_assign(cost2, act, row_assign,
                                              col_assign)

    # ---- 5: lost-track recovery ------------------------------------------
    lost_gate = spatial_gate(track_centers, det_centers, velocities, act,
                             states,
                             config.gate_threshold * C.LOST_GATE_SCALE)
    only_lost = act & (states == C.TRACK_STATE_LOST)
    lost_gate = lost_gate & only_lost[:, None] & dvalid[None, :]
    cost3 = torch.where(lost_gate, 1.0 - oks_matrix(predicted, det.poses, 0.2),
                        LOCK_COST)
    if use_reid:
        cost3 = blend_reid_cost(cost3, reid_cost, config.reid_weight)
    cost3 = _lock(cost3, row_assign, col_assign)
    row_assign, col_assign = _tier_assign(cost3, act, row_assign, col_assign)

    # ---- 6: update matched tracks ----------------------------------------
    matched = (row_assign >= 0) & act
    det_idx = row_assign.clamp(0, D - 1).long()
    if use_kf136:
        kf = Kalman136.update(kf, det.poses, torch.arange(T, **i32),
                              row_assign, matched)
        kf_split = kf.mean.reshape(T, C.NUM_KEYPOINTS, 8)
        m3 = matched[:, None, None]
        poses = torch.cat(
            [torch.where(m3, kf_split[..., 0:2], state.poses[..., :2]),
             torch.where(m3, det.poses[det_idx][..., 2:3],
                         state.poses[..., 2:3])], dim=-1)
        velocities = kf_split[..., 2:4]
    else:
        poses, velocities = cv_update(state.poses, velocities, det.poses,
                                      row_assign, act)
    scores = torch.where(matched, det.scores[det_idx], state.scores)
    hits = torch.where(matched, state.hits + 1, state.hits)
    ages = torch.where(matched, 0, state.ages)
    last_frame = torch.where(matched, frame, state.last_frame)
    promote = matched & (states == C.TRACK_STATE_TENTATIVE) & \
        (hits >= config.min_hits)
    reactivate = matched & (states == C.TRACK_STATE_LOST)
    states = torch.where(promote | reactivate, C.TRACK_STATE_CONFIRMED,
                         states)

    # ---- 7: age unmatched tracks -----------------------------------------
    unmatched = ~matched & act
    ages = torch.where(unmatched, ages + 1, ages)
    tent_dead = unmatched & (states == C.TRACK_STATE_TENTATIVE) & \
        (ages > C.TENTATIVE_MAX_AGE)
    to_lost = unmatched & (states == C.TRACK_STATE_CONFIRMED) & \
        (ages > config.max_age)
    lost_dead = unmatched & (states == C.TRACK_STATE_LOST) & \
        (ages > config.max_age + config.lost_window)
    states = torch.where(to_lost, C.TRACK_STATE_LOST, states)
    active = act & ~(tent_dead | lost_dead)

    # ---- 8: new tracks (prefix-sum slot allocation) ----------------------
    new_det = dvalid & (col_assign < 0) & \
        (det.scores >= config.new_track_thresh)
    det_rank = (torch.cumsum(new_det.to(torch.int32), 0) - 1).to(torch.int32)
    free = ~active
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    num_free = free.sum()
    slot_ids = torch.arange(T, **i32)
    # free_slots[r] = index of the r-th free slot
    free_slots = scatter_rows(torch.full((T,), T, **i32),
                              torch.where(free, free_rank, T), slot_ids)
    ok = new_det & (det_rank < num_free)
    slot_for_det = torch.where(
        ok, free_slots[det_rank.clamp(0, T - 1).long()], -1)
    scatter_slot = torch.where(ok, slot_for_det, T).long()
    new_ids = state.next_id + det_rank

    def per_det(value):                       # [D] filled on the device
        return torch.full((D,), value, **i32)

    poses = scatter_rows(poses, scatter_slot, det.poses)
    velocities = scatter_rows(velocities, scatter_slot,
                              torch.zeros_like(det.poses[..., :2]))
    scores = scatter_rows(scores, scatter_slot, det.scores)
    ids = scatter_rows(state.ids, scatter_slot, new_ids)
    hits = scatter_rows(hits, scatter_slot, per_det(1))
    ages = scatter_rows(ages, scatter_slot, per_det(0))
    states = scatter_rows(states, scatter_slot,
                          per_det(C.TRACK_STATE_TENTATIVE))
    last_frame = scatter_rows(last_frame, scatter_slot, frame.expand(D))
    active = scatter_rows(active, scatter_slot, per_det(1))
    col_assign = torch.where(ok, slot_for_det, col_assign)
    num_new = ok.sum()
    next_id = (state.next_id + num_new).to(torch.int32)
    kf_mean, kf_cov = state.kf_mean, state.kf_cov
    if use_kf136:
        kf = Kalman136.initiate(kf, det.poses, scatter_slot, ok)
        kf_mean, kf_cov = kf.mean, kf.cov_diag
    embeddings = state.embeddings
    if use_reid:
        embeddings = ema_update(embeddings, det_embeddings[det_idx], matched,
                                gamma=config.reid_ema)
        embeddings = scatter_rows(embeddings, scatter_slot, det_embeddings)

    # ---- 9: duplicate suppression ----------------------------------------
    # Centres from gating time, as in the reference (tracks born this frame
    # are excluded by the min_hits rule).
    eligible = active & (states != C.TRACK_STATE_LOST) & \
        (hits >= config.min_hits)
    iou = centers_iou_matrix(track_centers)
    eye = torch.eye(T, dtype=torch.bool, device=dev)
    dup = eligible[:, None] & eligible[None, :] & ~eye & \
        (iou > config.dedup_iou_threshold)
    hl = hits[:, None] < hits[None, :]
    tie = (hits[:, None] == hits[None, :]) & (ids[:, None] > ids[None, :])
    active = active & ~(dup & (hl | tie)).any(dim=1)

    new_state = TrackerState(
        poses=poses, velocities=velocities, scores=scores, ids=ids,
        states=states, hits=hits, ages=ages, last_frame=last_frame,
        active=active, next_id=next_id, frame=frame,
        det_track_slot=col_assign, kf_mean=kf_mean, kf_cov=kf_cov,
        embeddings=embeddings)
    aux = {"num_active_in": num_active_in, "num_active": active.sum(),
           "num_matched": matched.sum(), "num_new": num_new,
           "predicted_poses": predicted}
    return new_state, aux

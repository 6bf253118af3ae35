"""Constant-velocity motion model: cv_predict and cv_update
(posebyte_tpu/ops/kalman.py; reference: kernelKalmanPredict /
kernelKalmanUpdate, gpu_tracker.cu:102-189). Kalman136 is not ported yet.
"""
from __future__ import annotations

import torch

from ..core import constants as C

CV_PROCESS_NOISE = 0.1
CV_MEASUREMENT_NOISE = 0.3
CV_VELOCITY_ALPHA = 0.3
CV_LOST_DECAY = 0.95


def cv_predict(poses: torch.Tensor, velocities: torch.Tensor,
               active: torch.Tensor, states: torch.Tensor, dt: float = 1.0):
    """poses [T, 17, 3], velocities [T, 17, 2] -> (predicted poses,
    velocities); lost tracks decay their velocity by 0.95 per frame."""
    act = active[:, None, None]
    pred_xy = poses[..., :2] + velocities * dt
    predicted = torch.cat([torch.where(act, pred_xy, poses[..., :2]),
                           poses[..., 2:3]], dim=-1)
    lost = ((states == C.TRACK_STATE_LOST) & active)[:, None, None]
    return predicted, torch.where(lost, velocities * CV_LOST_DECAY,
                                  velocities)


def cv_update(poses: torch.Tensor, velocities: torch.Tensor,
              det_poses: torch.Tensor, row_assign: torch.Tensor,
              active: torch.Tensor,
              process_noise: float = CV_PROCESS_NOISE,
              measurement_noise: float = CV_MEASUREMENT_NOISE,
              alpha: float = CV_VELOCITY_ALPHA):
    """Constant-gain update of matched tracks: K = R / (R + Q) toward the
    detection, velocity by exponential smoothing of the innovation, track
    confidence <- detection confidence."""
    D = det_poses.shape[0]
    K = measurement_noise / (measurement_noise + process_noise)
    matched = (row_assign >= 0) & active
    det = det_poses[row_assign.clamp(0, D - 1).long()]         # [T, 17, 3]
    innov = det[..., :2] - poses[..., :2]
    new_xy = poses[..., :2] + K * innov
    new_vel = alpha * innov + (1.0 - alpha) * velocities
    m = matched[:, None, None]
    out_poses = torch.cat([torch.where(m, new_xy, poses[..., :2]),
                           torch.where(m, det[..., 2:3], poses[..., 2:3])],
                          dim=-1)
    return out_poses, torch.where(m, new_vel, velocities)

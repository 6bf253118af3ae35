"""The two motion models (posebyte_tpu/ops/kalman.py):

1. cv_predict / cv_update, the constant-gain constant-velocity filter
   (reference: kernelKalmanPredict / kernelKalmanUpdate,
   gpu_tracker.cu:102-189).
2. Kalman136, the batched third-order (position, velocity, acceleration,
   jerk) filter over the 17 keypoints, mean and covariance diagonal
   [T, 136] (reference: kalman_filter.cu:24-264). Kernel 3
   (csrc/tracker_chunk.cu) computes the same arithmetic in the same order:
   p + v + 0.5 a + (1/6) j left to right with float32(1/6), the process
   noise of _PROCESS_NOISE_DIAG (float32 squares), no fused operations.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import constants as C
from ..core.structs import KalmanState136, scatter_rows

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


# Per-order process-noise standard deviations (reference:
# kalman_filter.cu:152-163), squared in float32 as the JAX package squares
# them: 0.1f^2 = 0.010000000707805157, not the literal 0.01.
_ORDER_NOISE = np.repeat(np.asarray([1.0, 0.5, 0.1, 0.05], np.float32), 2)
_PROCESS_NOISE_DIAG = np.tile(_ORDER_NOISE ** 2, (C.NUM_KEYPOINTS,))  # [136]


@functools.lru_cache(maxsize=None)
def _process_noise(device: torch.device) -> torch.Tensor:
    """_PROCESS_NOISE_DIAG on `device`, copied there once."""
    return torch.from_numpy(_PROCESS_NOISE_DIAG).to(device)


def _split(mean: torch.Tensor) -> torch.Tensor:
    """[..., 136] -> [..., 17, 8] as (px, py, vx, vy, ax, ay, jx, jy)."""
    return mean.reshape(*mean.shape[:-1], C.NUM_KEYPOINTS, 8)


class Kalman136:
    """Batched third-order Kalman filter over the slot pool: pure functions
    of KalmanState136 (reference: include/cuda/kalman_filter.h:19-56). The
    input state is not modified."""

    @staticmethod
    def initiate(state: KalmanState136, detections: torch.Tensor,
                 slots: torch.Tensor, valid: torch.Tensor) -> KalmanState136:
        """Slots `slots` [N] from detections [N, 17, 3] where `valid`
        (reference: kernelBatchInitiate, kalman_filter.cu:24-82): mean <-
        the detection's x, y and zero derivatives; covariance diagonal:
        position 10 (1000 where conf <= 0), the rest 100. Invalid entries
        are dropped, never clipped and then overwritten."""
        N = detections.shape[0]
        f32 = dict(dtype=torch.float32, device=detections.device)
        new_mean = torch.cat([detections[..., :2],
                              torch.zeros((N, C.NUM_KEYPOINTS, 6), **f32)],
                             dim=-1).reshape(N, C.TOTAL_STATE_DIM)
        pos_var = torch.where(detections[..., 2] > 0.0, 10.0, 1000.0)
        new_cov = torch.cat([pos_var[..., None].expand(N, C.NUM_KEYPOINTS, 2),
                             torch.full((N, C.NUM_KEYPOINTS, 6), 100.0,
                                        **f32)],
                            dim=-1).reshape(N, C.TOTAL_STATE_DIM)
        T = state.mean.shape[0]
        idx = torch.where(valid, slots, T).long()
        return KalmanState136(mean=scatter_rows(state.mean, idx, new_mean),
                              cov_diag=scatter_rows(state.cov_diag, idx,
                                                    new_cov))

    @staticmethod
    def predict(state: KalmanState136, accel_memory: float = 0.9,
                jerk_memory: float = 0.9) -> KalmanState136:
        """Closed-form third-order transition of every slot, plus the
        diagonal process noise (reference: kernelPredictMean /
        kernelPredictCovariance, kalman_filter.cu:86-167)."""
        s = _split(state.mean)
        p, v, a, j = s[..., 0:2], s[..., 2:4], s[..., 4:6], s[..., 6:8]
        new_p = p + v + 0.5 * a + (1.0 / 6.0) * j
        new_v = v + a + 0.5 * j
        mean = torch.cat([new_p, new_v, a * accel_memory, j * jerk_memory],
                         dim=-1).reshape(state.mean.shape)
        return KalmanState136(
            mean=mean,
            cov_diag=state.cov_diag + _process_noise(state.cov_diag.device))

    @staticmethod
    def update(state: KalmanState136, detections: torch.Tensor,
               track_slots: torch.Tensor, det_indices: torch.Tensor,
               valid: torch.Tensor) -> KalmanState136:
        """Per-keypoint scalar-gain update of the (slot, detection) pairs
        where `valid` (reference: kernelBatchUpdate, kalman_filter.cu:171-
        237): R = 5 / (conf + 0.1); keypoints with conf < 0.1 keep their
        state; K = P / (P + R) per axis; both velocities take the x axis's
        gain, K_v = 0.5 K_x; P <- (1 - K) P. Invalid pairs are dropped."""
        T = state.mean.shape[0]
        safe_slot = track_slots.clamp(0, T - 1).long()
        safe_det = det_indices.clamp(0, detections.shape[0] - 1).long()
        mean_kp = _split(state.mean)[safe_slot]                # [M, 17, 8]
        cov_kp = _split(state.cov_diag)[safe_slot]
        det = detections[safe_det]                             # [M, 17, 3]
        conf = det[..., 2]
        u = ((conf >= 0.1) & valid[:, None])[..., None]        # [M, 17, 1]
        innov = det[..., :2] - mean_kp[..., 0:2]
        P_pos = cov_kp[..., 0:2]
        # a true division, as JAX's 5.0 / x (PyTorch's 5.0 / x would
        # multiply by the reciprocal)
        R = (torch.full_like(conf, 5.0) / (conf + 0.1))[..., None]
        K = P_pos / (P_pos + R)
        new_pos = mean_kp[..., 0:2] + torch.where(u, K * innov, 0.0)
        K_v = 0.5 * K[..., 0:1]
        new_vel = mean_kp[..., 2:4] + torch.where(u, K_v * innov, 0.0)
        new_mean = torch.cat([new_pos, new_vel, mean_kp[..., 4:8]], dim=-1)
        new_cov = torch.cat([torch.where(u, (1.0 - K) * P_pos, P_pos),
                             cov_kp[..., 2:8]], dim=-1)
        idx = torch.where(valid, track_slots, T).long()
        return KalmanState136(
            mean=scatter_rows(state.mean, idx,
                              new_mean.reshape(-1, C.TOTAL_STATE_DIM)),
            cov_diag=scatter_rows(state.cov_diag, idx,
                                  new_cov.reshape(-1, C.TOTAL_STATE_DIM)))

    @staticmethod
    def extract_poses(state: KalmanState136) -> torch.Tensor:
        """[T, 136] -> poses [T, 17, 3] with confidence 1 (reference:
        kernelExtractPosesToDevice, kalman_filter.cu:241-264)."""
        s = _split(state.mean)
        return torch.cat([s[..., 0:2], torch.ones_like(s[..., 0:1])], dim=-1)

"""Velocity-adaptive spatial gating (posebyte_tpu/ops/gating.py;
reference: kernelSpatialGate, gpu_tracker.cu:241-317)."""
from __future__ import annotations

import torch

from ..core import constants as C
from .oks import torso_index


def spatial_gate(track_centers: torch.Tensor, det_centers: torch.Tensor,
                 track_velocities: torch.Tensor, track_active: torch.Tensor,
                 track_states: torch.Tensor,
                 gate_threshold: float = C.GATE_THRESHOLD) -> torch.Tensor:
    """[T, 4] x [D, 4] -> [T, D] bool gate.

    Inactive tracks gate to False; a degenerate centre box (w or h < 1 px)
    gates to True; otherwise centre distance / mean size must be under
    gate_threshold * (1 + min(torso speed / mean size, 2)), doubled for
    LOST tracks."""
    t_c = track_centers[:, None, :]
    d_c = det_centers[None, :, :]
    degenerate = ((t_c[..., 2] < 1.0) | (t_c[..., 3] < 1.0)
                  | (d_c[..., 2] < 1.0) | (d_c[..., 3] < 1.0))
    diff = t_c[..., :2] - d_c[..., :2]
    dist = torch.sqrt((diff * diff).sum(dim=-1))                 # [T, D]
    avg_size = (t_c[..., 2] + t_c[..., 3]
                + d_c[..., 2] + d_c[..., 3]) * 0.25
    ratio = dist / (avg_size + 1e-6)

    torso = torso_index(track_velocities.device)
    speed = torch.linalg.vector_norm(track_velocities[:, torso, :],
                                     dim=-1).mean(dim=-1)        # [T]
    threshold = gate_threshold * (
        1.0 + torch.clamp_max(speed[:, None] / (avg_size + 1e-6), 2.0))
    threshold = torch.where(
        (track_states == C.TRACK_STATE_LOST)[:, None], threshold * 2.0,
        threshold)
    return (degenerate | (ratio < threshold)) & track_active[:, None]

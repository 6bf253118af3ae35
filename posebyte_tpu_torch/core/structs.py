"""Detection set and tracker slot pool as dataclasses of torch tensors.

Field names, shapes and dtypes follow posebyte_tpu/core/structs.py:18-104,
so that a state can be moved between the packages field by field and later
slices (the fused tracker kernel, Kalman136, Re-ID) keep the layout. The
slot pool is the reference's persistent device buffers
(reference: include/cuda/gpu_tracker.h:129-177).
"""
from __future__ import annotations

import dataclasses

import torch

from . import constants as C


@dataclasses.dataclass
class Detections:
    """Padded detection set (reference: PoseDetection, types.h:68-106).

    `valid` masks real entries. `poses` is [N, 17, 3] (x, y, conf) and
    `boxes` [N, 4] xyxy, both float32; `scores` [N] float32; `valid` [N]
    bool.
    """
    poses: torch.Tensor
    boxes: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.poses.shape[-3]


@dataclasses.dataclass
class TrackerState:
    """Persistent track slot pool (reference: gpu_tracker.h:129-177).

    One row per slot; `active` marks live tracks. Integer state is int32;
    `next_id` and `frame` are 0-d int32 tensors. `det_track_slot` [D] maps
    each detection of the last frame to its track slot or -1. `kf_mean`,
    `kf_cov` [T, 136] and `embeddings` [T, 51] are carried unchanged by the
    cv motion model without Re-ID.
    """
    poses: torch.Tensor        # [T, 17, 3] float32
    velocities: torch.Tensor   # [T, 17, 2] float32
    scores: torch.Tensor       # [T] float32
    ids: torch.Tensor          # [T] int32
    states: torch.Tensor       # [T] int32 (0 tent / 1 confirmed / 2 lost)
    hits: torch.Tensor         # [T] int32
    ages: torch.Tensor         # [T] int32
    last_frame: torch.Tensor   # [T] int32
    active: torch.Tensor       # [T] bool
    next_id: torch.Tensor      # [] int32, starts at 1
    frame: torch.Tensor        # [] int32
    det_track_slot: torch.Tensor  # [D] int32
    kf_mean: torch.Tensor      # [T, 136] float32
    kf_cov: torch.Tensor       # [T, 136] float32 (diagonal)
    embeddings: torch.Tensor   # [T, 51] float32

    @staticmethod
    def init(max_tracks: int = C.DEFAULT_MAX_TRACKS,
             max_detections: int = C.DEFAULT_MAX_DETECTIONS,
             device="cpu") -> "TrackerState":
        T = max_tracks
        f32 = dict(dtype=torch.float32, device=device)
        i32 = dict(dtype=torch.int32, device=device)
        return TrackerState(
            poses=torch.zeros((T, C.NUM_KEYPOINTS, 3), **f32),
            velocities=torch.zeros((T, C.NUM_KEYPOINTS, 2), **f32),
            scores=torch.zeros((T,), **f32),
            ids=torch.zeros((T,), **i32),
            states=torch.zeros((T,), **i32),
            hits=torch.zeros((T,), **i32),
            ages=torch.zeros((T,), **i32),
            last_frame=torch.zeros((T,), **i32),
            active=torch.zeros((T,), dtype=torch.bool, device=device),
            next_id=torch.ones((), **i32),
            frame=torch.zeros((), **i32),
            det_track_slot=torch.full((max_detections,), -1, **i32),
            kf_mean=torch.zeros((T, C.TOTAL_STATE_DIM), **f32),
            kf_cov=torch.ones((T, C.TOTAL_STATE_DIM), **f32),
            embeddings=torch.zeros((T, C.NUM_KEYPOINTS * 3), **f32),
        )

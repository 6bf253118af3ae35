"""Configuration dataclasses: the fields and defaults of
posebyte_tpu/core/config.py, so that one configuration describes a run of
either package.

Reference: include/cuda/gpu_tracker.h:16-26, include/types.h:135-155,
src/main.cpp:132-141.
"""
from __future__ import annotations

import dataclasses

from . import constants as C


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """GPU-native tracker configuration (reference: gpu_tracker.h:16-26)."""
    max_tracks: int = C.DEFAULT_MAX_TRACKS
    max_detections: int = C.DEFAULT_MAX_DETECTIONS
    match_threshold: float = 0.5    # cost threshold (1 - OKS)
    high_thresh: float = 0.30       # two-tier high-confidence split
    low_thresh: float = 0.15        # two-tier low-confidence floor
    new_track_thresh: float = 0.30  # min confidence to spawn a track
    max_age: int = 10               # frames before confirmed -> lost
    min_hits: int = 3               # hits before tentative -> confirmed

    # "cv": the constant-gain constant-velocity filter
    # (gpu_tracker.cu:102-189); "kalman136": the third-order 136-D filter
    # (kalman_filter.cu, ops/kalman.py::Kalman136) with these memories.
    motion_model: str = "cv"
    accel_memory: float = 0.9
    jerk_memory: float = 0.9

    lost_window: int = C.LOST_WINDOW
    gate_threshold: float = C.GATE_THRESHOLD
    visibility_threshold: float = C.VISIBILITY_THRESHOLD
    dedup_iou_threshold: float = C.DEDUP_IOU_THRESHOLD

    # Stage-4 torso-OKS fallback tier (gpu_tracker.cu:429).
    torso_tier: bool = True

    # Appearance Re-ID blend; 0 = pure geometric association
    # (ops/reid.py). reid_ema: the per-track embedding's EMA factor.
    reid_weight: float = 0.0
    reid_ema: float = 0.9
    # The JAX package's choice of sampling lowering ("direct", "block" or
    # "auto"), kept so that its configs load; the port samples by index
    # gathers for every value, which give the values of both.
    reid_sample_impl: str = "auto"

    @staticmethod
    def from_conf_threshold(conf: float, **kw) -> "TrackerConfig":
        """Tracker thresholds from the detector's confidence, as the demo
        CLI derives them (reference: src/main.cpp:132-141, low = conf *
        0.5)."""
        return TrackerConfig(high_thresh=conf, low_thresh=conf * 0.5,
                             new_track_thresh=conf, **kw)

    def __post_init__(self):
        if self.motion_model not in ("cv", "kalman136"):
            raise ValueError(f"motion_model must be 'cv' or 'kalman136', "
                             f"got {self.motion_model!r}")
        if self.reid_sample_impl not in ("direct", "block", "auto"):
            raise ValueError(
                f"reid_sample_impl must be 'direct', 'block' or 'auto', got "
                f"{self.reid_sample_impl!r}")


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Detection + postprocess configuration
    (reference: yolo_pose_engine.h:59-130, gpu_postprocess.cu:366-476)."""
    input_size: int = C.DEFAULT_INPUT_SIZE
    num_anchors: int = C.DEFAULT_NUM_ANCHORS
    conf_threshold: float = 0.25
    iou_threshold: float = 0.55     # NMS IoU
    oks_threshold: float = 0.55     # NMS OKS
    max_candidates: int = 256       # pre-NMS top-k
    max_detections: int = C.DEFAULT_MAX_DETECTIONS
    # Candidate ranking: "sort" (exact, stable ties) is the one ported.
    topk_impl: str = "sort"
    # Candidate-row extraction. "index" and "onehot" give the same values;
    # the port always gathers by index.
    gather_impl: str = "onehot"
    # Candidate selection after ("post") the pyramid-level concat; "tail"
    # is not ported yet.
    decode_fusion: str = "post"
    # Raw u8 letterbox with the BGR flip and /255 folded into the stem conv
    # (models.weights.fold_stem_preprocess).
    raw_preproc: bool = True

    def __post_init__(self):
        if self.decode_fusion not in ("post", "tail"):
            raise ValueError(
                f"decode_fusion must be 'post' or 'tail', got "
                f"{self.decode_fusion!r}")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end frame pipeline configuration."""
    detector: DetectorConfig = DetectorConfig()
    tracker: TrackerConfig = TrackerConfig()
    model_name: str = "yolov8n-pose"
    precision: str = "bf16"         # fp32 | bf16 | int8 (bf16 activations)

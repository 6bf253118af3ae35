"""Core data model constants (own copy of posebyte_tpu/core/constants.py).

Plain numpy arrays and python constants, after the reference C++ data
model (reference: include/types.h:17-174). The port keeps its own copy so
that it never imports the JAX package.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# COCO keypoints (reference: include/types.h:17-36)
# ---------------------------------------------------------------------------
NOSE = 0
LEFT_EYE = 1
RIGHT_EYE = 2
LEFT_EAR = 3
RIGHT_EAR = 4
LEFT_SHOULDER = 5
RIGHT_SHOULDER = 6
LEFT_ELBOW = 7
RIGHT_ELBOW = 8
LEFT_WRIST = 9
RIGHT_WRIST = 10
LEFT_HIP = 11
RIGHT_HIP = 12
LEFT_KNEE = 13
RIGHT_KNEE = 14
LEFT_ANKLE = 15
RIGHT_ANKLE = 16
NUM_KEYPOINTS = 17

KEYPOINT_NAMES = (
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
)

# Per-keypoint OKS falloff (reference: include/types.h:40-58)
COCO_SIGMAS = np.array(
    [0.026, 0.025, 0.025, 0.035, 0.035,
     0.079, 0.079, 0.072, 0.072,
     0.062, 0.062, 0.107, 0.107,
     0.087, 0.087, 0.089, 0.089],
    dtype=np.float32,
)

# Torso keypoints used for velocity estimation / low-confidence fallback OKS
# (reference: src/cuda/gpu_tracker.cu:289, 465)
TORSO_KEYPOINTS = np.array([LEFT_SHOULDER, RIGHT_SHOULDER, LEFT_HIP, RIGHT_HIP],
                           dtype=np.int32)

# COCO skeleton edge list used by visualization
# (reference: src/utils/video_utils.cpp:34-48)
SKELETON_EDGES = np.array([
    (0, 1), (0, 2), (1, 3), (2, 4),            # head
    (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),   # arms
    (5, 11), (6, 12), (11, 12),                # torso
    (11, 13), (13, 15), (12, 14), (14, 16),    # legs
    (0, 5), (0, 6),                            # neck
    (3, 5),                                    # ear-shoulder
], dtype=np.int32)

# ---------------------------------------------------------------------------
# Track states (reference: src/cuda/gpu_tracker.cu:24-27 and types.h:109-114)
# ---------------------------------------------------------------------------
TRACK_STATE_TENTATIVE = 0
TRACK_STATE_CONFIRMED = 1
TRACK_STATE_LOST = 2

# ---------------------------------------------------------------------------
# Third-order Kalman filter dims (reference: include/types.h:120-123)
# ---------------------------------------------------------------------------
MOTION_ORDERS = 4          # pos, vel, acc, jerk
COORDS_PER_KP = 2          # x, y
STATE_DIM_PER_KP = MOTION_ORDERS * COORDS_PER_KP   # 8
TOTAL_STATE_DIM = NUM_KEYPOINTS * STATE_DIM_PER_KP  # 136

# ---------------------------------------------------------------------------
# Tracker compile-time constants (reference: include/cuda/gpu_tracker.h:119-122)
# ---------------------------------------------------------------------------
LOST_WINDOW = 10                 # extra frames lost tracks survive
GATE_THRESHOLD = 3.0             # base spatial gate ratio
VISIBILITY_THRESHOLD = 0.2       # keypoint visibility for OKS
DEDUP_IOU_THRESHOLD = 0.7        # duplicate track suppression
TENTATIVE_MAX_AGE = 2            # tentative dies if age > 2 (gpu_tracker.cu:674)
LOST_GATE_SCALE = 1.3            # lost tier gate multiplier (gpu_tracker.cu:1368)
LOW_TIER_THRESH_SCALE = 1.2      # relaxed match threshold (gpu_tracker.cu:1309)

# Pipeline capacities (reference: gpu_tracker.h:17-18, gpu_postprocess usage)
DEFAULT_MAX_TRACKS = 128
DEFAULT_MAX_DETECTIONS = 64
DEFAULT_NUM_ANCHORS = 8400       # 640x640 at strides 8/16/32
DEFAULT_INPUT_SIZE = 640
LETTERBOX_PAD_VALUE = 114.0 / 255.0  # gray padding (preprocess.cu:43)
LETTERBOX_PAD_RAW = 114              # same gray, un-normalized (raw mode)

"""posebyte_tpu_torch: the PyTorch + CUDA port of posebyte_tpu for an
NVIDIA H100.

The port mirrors the JAX package's layout (core/, ops/, models/, tracker/,
pipeline/, utils/) and is held against it by tests/test_torch_*.py. Its
entry points run on the CUDA card unless the caller passes device="cpu".
The TPU kernels on its path are CUDA C++ kernels in csrc/ (pose-NMS keep
mask, auction), built with nvcc on first use (ops/cuda_lib.py). Importing
the package builds nothing, initialises no device and imports no triton.
"""
__version__ = "0.1.0"

from .core import (Detections, DetectorConfig, PipelineConfig,
                   TrackerConfig, TrackerState)
from .tracker import get_active_tracks, tracker_step

__all__ = ["TrackerConfig", "DetectorConfig", "PipelineConfig",
           "Detections", "TrackerState", "tracker_step",
           "get_active_tracks", "__version__"]

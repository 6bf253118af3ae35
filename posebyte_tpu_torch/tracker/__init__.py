"""Two-tier ByteTrack pose tracker (reference: src/cuda/gpu_tracker.cu)."""
from .output import TrackOutput, extract_outputs_device
from .step import LOCK_COST, tracker_step

__all__ = ["tracker_step", "LOCK_COST", "TrackOutput",
           "extract_outputs_device"]

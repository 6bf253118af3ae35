"""The per-frame pipeline (the chunked and serving paths wait for later
slices)."""
from .runner import PosePipeline

__all__ = ["PosePipeline"]

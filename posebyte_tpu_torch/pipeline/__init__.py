"""The pose pipeline (per frame and per chunk), the multi-stream servers and
their TCP front end."""
from .runner import Detector, PosePipeline, detect_fn


def __getattr__(name):
    # The servers and the front end load on first touch, so that importing
    # the pipeline stays light.
    if name in ("StreamServer", "ChunkedStreamServer"):
        from . import serving
        return getattr(serving, name)
    if name in ("PoseServingFrontend", "PoseClient"):
        from . import frontend
        return getattr(frontend, name)
    raise AttributeError(name)


__all__ = ["PosePipeline", "Detector", "detect_fn", "StreamServer",
           "ChunkedStreamServer",
           "PoseServingFrontend", "PoseClient"]

"""Idle ms a chunk of the card under the program's "chunk" range and its
children, the stages' ranges: the card waiting for the host while it
enqueues a chunk (process_chunk_device, pipeline/runner.py). An idle gap
counts under the innermost range open at its midpoint
(harness/trace.py). None untraced, and where the program's table of
range names (utils/profiling.py STAGES) has no "chunk"."""
UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Pipeline (pipeline/runner.py)"
MOVES = "fps"
SPANS = ("chunk", "letterbox", "model", "decode", "nms", "reid", "tracker")


def read(ctx):
    from posebyte_tpu_torch.utils import profiling
    t = ctx.trace
    if t is None or t.busy_s <= 0 \
            or not set(SPANS) <= set(getattr(profiling, "STAGES", ())):
        return None
    return 1e3 * sum(t.gaps.get(s, 0.0) for s in SPANS) / t.chunks

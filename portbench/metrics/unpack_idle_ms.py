"""Idle ms a chunk of the card under the program's "fetch.tracks" range:
the host turning a fetched chunk's outputs into per-frame track lists
(chunk_tracks in fetch_chunk_outputs, pipeline/runner.py) while, one
chunk in flight, the card waits for the next chunk. An idle gap counts
under the innermost range open at its midpoint (harness/trace.py). None
untraced, and where the program's table of range names
(utils/profiling.py STAGES) has no "fetch.tracks"."""
UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Outputs (tracker/output.py, fetch_chunk_outputs)"
MOVES = "fps"
SPAN = "fetch.tracks"


def read(ctx):
    from posebyte_tpu_torch.utils import profiling
    t = ctx.trace
    if t is None or t.busy_s <= 0 \
            or SPAN not in getattr(profiling, "STAGES", ()):
        return None
    return 1e3 * t.gaps.get(SPAN, 0.0) / t.chunks

"""Host time of process_chunk_device, the call that enqueues a chunk
(pipeline/runner.py), mean ms a chunk over the chunks outside the
profiled ones."""
UNIT = "ms"
SOURCE = "host_clock"
LAYER = "Pipeline (pipeline/runner.py)"
MOVES = "fps"


def read(ctx):
    c = ctx.untraced_chunks()
    return 1e3 * sum(t1 - t0 for t0, t1, _, _ in c) / len(c)

"""Host time of fetch_chunk_outputs (the packed output copy, which waits
for the chunk, and the host's unpacking; tracker/output.py, runner.py),
mean ms a chunk over the chunks outside the profiled ones. The program's
"fetch" range holds the packing's device work."""
UNIT = "ms"
SOURCE = "host_clock"
LAYER = "Outputs (tracker/output.py, fetch_chunk_outputs)"
MOVES = "chunk_latency_p95_ms"
STAGE = "fetch"


def read(ctx):
    c = ctx.untraced_chunks()
    return 1e3 * sum(t2 - t1 for _, t1, t2, _ in c) / len(c)

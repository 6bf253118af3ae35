"""The 95th percentile over every chunk of the window of the time from the
process_chunk_device call to fetch_chunk_outputs returning."""
import numpy as np

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    return float(np.percentile(ctx.latencies_ms(ctx.chunks), 95))

"""The share of the profiled chunks' wall time in which no kernel, copy
or set ran on the card, in %."""
UNIT = "%"
SOURCE = "device_trace"
LAYER = "Device (one H100)"
MOVES = "fps"


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

"""Frames whose outputs were fetched in the window, over the window's
time (from the first chunk's call to the last chunk's fetch)."""
UNIT = "frames/s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.frames / ctx.window_s

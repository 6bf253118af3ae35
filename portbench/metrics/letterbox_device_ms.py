"""Device ms a frame of the kernels inside the program's "letterbox"
range (ops/preprocess.py)."""
UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Letterbox (ops/preprocess.py)"
MOVES = "fps"
STAGE = "letterbox"


def read(ctx):
    return ctx.layer_ms_per_frame(STAGE)

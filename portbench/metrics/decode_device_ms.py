"""Device ms a frame of the kernels inside the program's "decode" range
(ops/decode.py, ops/topk.py)."""
UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Decode (ops/decode.py, ops/topk.py)"
MOVES = "fps"
STAGE = "decode"


def read(ctx):
    return ctx.layer_ms_per_frame(STAGE)

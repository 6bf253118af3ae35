"""Device ms a frame of the model: the kernels inside the program's
"model" range, plus Kernel 4 (conv_int8_kernel) by name, which the
profiler places in no range (models/yolo_pose.py, layers.py)."""
UNIT = "ms"
SOURCE = "device_trace"
LAYER = "Model (models/yolo_pose.py, layers.py)"
MOVES = "fps"
STAGE = "model"
KERNELS = ("conv_int8_kernel",)


def read(ctx):
    return ctx.layer_ms_per_frame(STAGE, KERNELS)

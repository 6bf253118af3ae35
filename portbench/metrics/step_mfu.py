"""The whole step's share of the card's peak: the least time the
forward's operations need at the published peaks (work/model_flops.py:
quantised convs at the int8 rate, the rest at the bf16 rate), a frame,
over the wall time a frame took in the window's chunks outside the
profiled ones, in %."""
UNIT = "%"
SOURCE = "host_clock"
LAYER = "Model (models/yolo_pose.py, layers.py)"
MOVES = "fps"


def read(ctx):
    if ctx.peaks is None:
        return None
    mf = ctx.work("model_flops")
    c = ctx.untraced_chunks()
    wall = sum(t2 - t0 for t0, _, t2, _ in c) / sum(f for *_, f in c)
    return 100.0 * mf.least_time(ctx.config, ctx.peaks) / wall

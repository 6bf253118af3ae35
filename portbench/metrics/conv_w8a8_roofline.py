"""Kernel 4's share of its roofline: the least time the profiled frames'
w8a8 convs need (work/conv_w8a8.py on every quantised, non-depthwise conv
of work/model_flops.py's table, each the larger of its bytes over HBM
bandwidth and its operations over the int8 peak) over Kernel 4's device
time by name, in %."""
UNIT = "%"
SOURCE = "device_trace"
LAYER = "int8 conv (ops/conv_int8.py, Kernel 4)"
MOVES = "fps"
STAGE = "model"
KERNELS = ("conv_int8_kernel",)


def read(ctx):
    t = ctx.trace
    if t is None or ctx.peaks is None:
        return None
    busy = t.kernels_matching(KERNELS)
    if busy <= 0:
        return None
    mf, cw = ctx.work("model_flops"), ctx.work("conv_w8a8")
    pk = ctx.peaks
    least = 0.0
    for c in mf.conv_table(ctx.config):
        if not mf.is_quantised(ctx.config, c) or c.groups != 1:
            continue
        nbytes, ops = cw.work(c.cin, c.cout, c.k, c.groups, c.hw_in,
                              c.hw_out)
        least += max(nbytes / pk["hbm_bytes_s"], ops / pk["int8_ops_s"])
    return 100.0 * least * t.frames / busy

"""Kernel 1's share of its roofline: the least time the keep masks of the
profiled chunks need (work/nms_keep.py on the candidates of the profiled
calls, recorded as the program passes them) over the device time of
Kernel 1's two kernels by name, in %."""
import numpy as np

UNIT = "%"
SOURCE = "device_trace"
LAYER = "NMS (ops/nms.py, Kernel 1)"
MOVES = "fps"
STAGE = "nms"
KERNELS = ("nms_dominance_kernel", "nms_greedy_kernel")
PROBES = ("posebyte_tpu_torch.ops.nms:nms_keep",)


def read(ctx):
    t = ctx.trace
    calls = ctx.probe_calls(PROBES[0])
    if t is None or ctx.peaks is None or not calls:
        return None
    busy = t.kernels_matching(KERNELS)
    if busy <= 0:
        return None
    wk, pk = ctx.work("nms_keep"), ctx.peaks
    thr = ctx.config["detector"]["iou_threshold"]
    least = []
    for args, kwargs, _ in calls:
        poses, boxes, valid = (np.asarray(a.cpu()) for a in args[:3])
        nbytes, ops = wk.work(poses, boxes, valid, thr)
        least.append(max(nbytes / pk["hbm_bytes_s"], ops / pk["f32_ops_s"]))
    return 100.0 * float(np.mean(least)) * ctx.probe_count(PROBES[0]) / busy

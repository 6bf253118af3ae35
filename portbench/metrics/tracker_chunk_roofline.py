"""Kernel 3's share of its roofline: the least time the profiled chunks'
tracker recurrence needs (work/tracker_chunk.py on the detections, the
incoming state and the outputs of the profiled calls, recorded as the
program passes them) over Kernel 3's device time by name, in %."""
import numpy as np

UNIT = "%"
SOURCE = "device_trace"
LAYER = "Tracker (ops/tracker_chunk.py, Kernel 3)"
MOVES = "fps"
STAGE = "tracker"
KERNELS = ("tracker_chunk_kernel",)
PROBES = ("posebyte_tpu_torch.pipeline.runner:tracker_chunk",)


def read(ctx):
    t = ctx.trace
    calls = ctx.probe_calls(PROBES[0])
    if t is None or ctx.peaks is None or not calls:
        return None
    busy = t.kernels_matching(KERNELS)
    if busy <= 0:
        return None
    wk, pk = ctx.work("tracker_chunk"), ctx.peaks
    least = []
    for args, kwargs, (_, outs) in calls:
        state, dets = args[0], args[1]
        T, D = state.poses.shape[-3], dets.valid.shape[-1]
        nbytes, ops = wk.work(np.asarray(dets.valid.cpu()),
                              np.asarray(outs["num_active"].cpu()),
                              int(state.active.sum()), T, D)
        least.append(max(nbytes / pk["hbm_bytes_s"], ops / pk["f32_ops_s"]))
    return 100.0 * float(np.mean(least)) * ctx.probe_count(PROBES[0]) / busy

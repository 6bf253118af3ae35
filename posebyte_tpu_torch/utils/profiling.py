"""Where the time of the per-frame or the chunked path goes, on the card.

    python -m posebyte_tpu_torch.utils.profiling [--frames 32]
    python -m posebyte_tpu_torch.utils.profiling --chunk 128 [--frames 256]
    ... [--reid off|descriptor|head] [--motion cv|kalman136]
    ... [--precision bf16|int8]

Runs PosePipeline (yolov8n-pose, 640 input, bf16, raw u8 ingest; the
trained 640 checkpoint) on synthetic 1280x720 frames: each frame through
process_frame and fetch_outputs, or with --chunk K each chunk of K frames
through process_chunk and fetch_chunk_outputs. --warmup frames run first,
then --frames timed frames with the profiler off, and again with it on;
with --chunk both count whole chunks (by default one warm-up chunk and two
timed ones). --reid runs the tracker with Re-ID (reid_weight 0.3): the
pose-colour descriptor, or the learned head of
assets/reid-head-synthetic.safetensors. --motion picks the tracker's motion
model (the cv filter, or the third-order kalman136). --precision int8
runs the w8a8 path: the checkpoint quantised with PARTIAL_QUANT_SKIP and
calibrated by percentile on the card over 16 synthetic-scene frames at 640
(models/quant.py), every quantised conv through Kernel 4. Prints JSON
lines, every number per frame:
  steady      host wall ms per frame with the profiler off
  stages      per pipeline stage (the profiler labels of runner.py: ingest,
              letterbox, model, decode, nms, reid, tracker, outputs, fetch):
              host ms, and device ms of the kernels launched inside it,
              per frame, from torch.profiler
  device      device busy ms per frame (sum of kernel and copy times), device
              operations per frame, and the idle share 1 - busy / wall,
              against the profiled and the unprofiled wall time; Kernel
              4's device ms per frame (int8)
  kernels     the ten kernels with the most device time per frame
  tracker_stages  (--chunk) Kernel 3's stage clock: the unprofiled run's
              tracker launches made again on their own inputs with the
              clock on, each stage's cycles and share per frame, its us
              per frame (its share of Kernel 3's profiled device time),
              and each auction tier's rounds per frame and share of
              frames at the round budget
Device numbers come only from the profiler's CUDA activity; where it
records none they print as null ("not measured").
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np

STAGES = ("ingest", "letterbox", "model", "decode", "nms", "reid",
          "tracker", "outputs", "fetch")


def _frames(n: int, width: int = 1280, height: int = 720, persons: int = 6,
            seed: int = 7):
    from .synthetic import SyntheticScene, render_frame
    scene = SyntheticScene(persons, width, height, seed=seed)
    return [render_frame(scene.step(), width, height) for _ in range(n)]


@contextlib.contextmanager
def recorded_tracker_calls():
    """While active, every call the pipeline makes of the chunk tracker
    (pipeline.runner's tracker_chunk) is recorded: yields the list of its
    (args, kwargs), which are tracker_chunk_cuda's, to be launched again
    with the stage clock. The calls themselves, and the kernels' launch
    counts, are unchanged."""
    from ..pipeline import runner
    orig = runner.tracker_chunk
    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    runner.tracker_chunk = record
    try:
        yield calls
    finally:
        runner.tracker_chunk = orig


def clocked_split(calls, ms_per_frame=None) -> dict:
    """The recorded Kernel 3 launches made again with the stage clock
    on: the split (ops.tracker_chunk.read_stage_clock) over their frames."""
    import torch
    from ..ops import tracker_chunk as TC
    clock, frames = None, 0
    for args, kwargs in calls:
        scores = args[1].scores
        streams = scores.shape[0] if scores.dim() == 3 else 1
        if clock is None:
            clock = torch.zeros((streams, TC.CLOCK_COLUMNS),
                                dtype=torch.int64, device=scores.device)
        TC.tracker_chunk_cuda(*args, **kwargs, stage_cycles=(
            clock if scores.dim() == 3 else clock[0]))
        frames += scores.numel() // scores.shape[-1]
    return TC.read_stage_clock(clock, frames, ms_per_frame)


def _run(pipe, frames, w, h, chunk=0):
    """Frames through the pipeline; with `chunk`, `frames` is a list of
    stacked chunks [chunk, H, W, 3], stacked before the clock starts."""
    if chunk:
        for c in frames:
            pipe.fetch_chunk_outputs(pipe.process_chunk(c), w, h)
        return
    for fr in frames:
        pipe.fetch_outputs(pipe.process_frame(fr), w, h)


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core import PipelineConfig, TrackerConfig
    from ..models import load_params, load_reid_head
    from ..pipeline import PosePipeline

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=None,
                    help="timed frames (default 32, or 2 chunks)")
    ap.add_argument("--warmup", type=int, default=None,
                    help="warm-up frames (default 8, or 1 chunk)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="frames per chunk (0: the per-frame path)")
    ap.add_argument("--reid", choices=("off", "descriptor", "head"),
                    default="off", help="appearance Re-ID (reid_weight 0.3)")
    ap.add_argument("--motion", choices=("cv", "kalman136"), default="cv",
                    help="the tracker's motion model")
    ap.add_argument("--precision", choices=("bf16", "int8"), default="bf16",
                    help="int8: the w8a8 path through Kernel 4")
    args = ap.parse_args(argv)
    unit = args.chunk or 1
    if args.frames is None:
        args.frames = 2 * args.chunk if args.chunk else 32
    if args.warmup is None:
        args.warmup = args.chunk if args.chunk else 8
    if args.frames <= 0 or args.frames % unit or args.warmup % unit:
        ap.error(f"--frames and --warmup must be whole chunks of {unit}")
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    params, _ = load_params(os.path.join(
        root, "assets", "yolov8n-pose-synthetic640.safetensors"))
    cfg = PipelineConfig(precision=args.precision, tracker=TrackerConfig(
        motion_model=args.motion,
        reid_weight=0.0 if args.reid == "off" else 0.3))
    if args.precision == "int8":
        from ..models import quant
        from .synthetic import calibration_frames
        params = quant.calibrate_activations(
            quant.quantize_params(params), cfg.model_name,
            calibration_frames(16, 640, seed=7))
    reid_params = None
    if args.reid == "head":
        reid_params = load_reid_head(os.path.join(
            root, "assets", "reid-head-synthetic.safetensors"))
    pipe = PosePipeline(cfg, params, reid_params=reid_params)
    W, H = 1280, 720
    frames = _frames(args.warmup + args.frames)
    if args.chunk:                     # stacked before the clock starts
        frames = [np.stack(frames[i:i + args.chunk])
                  for i in range(0, len(frames), args.chunk)]
    warm = args.warmup // unit         # items of `frames` to warm up on
    _run(pipe, frames[:warm], W, H, args.chunk)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    with recorded_tracker_calls() as calls:
        _run(pipe, frames[warm:], W, H, args.chunk)
    wall = (time.perf_counter() - t0) * 1e3 / args.frames
    print(json.dumps({"phase": "steady", "frames": args.frames,
                      "chunk": args.chunk, "reid": args.reid,
                      "motion": args.motion,
                      "precision": args.precision,
                      "wall_ms_per_frame": wall,
                      "card": torch.cuda.get_device_name(0)}), flush=True)

    pipe.reset()
    _run(pipe, frames[:warm], W, H, args.chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run(pipe, frames[warm:], W, H, args.chunk)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / args.frames

    n = args.frames
    cpu = torch.autograd.DeviceType.CPU
    host, dev = dict.fromkeys(STAGES, 0.0), dict.fromkeys(STAGES, 0.0)
    per_kernel = defaultdict(float)
    count = 0
    for e in prof.events():
        if e.name in STAGES:
            # the host range of a stage; its device time sums the kernels
            # launched inside it (the profiler's own device-side copy of
            # the range is a span with gaps, not busy time, and is skipped)
            if e.device_type == cpu:
                host[e.name] += e.cpu_time_total / 1e3 / n
                dev[e.name] += e.device_time_total / 1e3 / n
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] += e.device_time_total / 1e3
            count += 1
    busy = sum(per_kernel.values()) / n
    measured = busy > 0
    print(json.dumps({"phase": "stages", "per_frame": {
        s: {"host_ms": host[s], "device_ms": dev[s] if measured else None}
        for s in STAGES}, "profiled_wall_ms_per_frame": prof_wall}),
        flush=True)
    print(json.dumps({
        "phase": "device",
        "busy_ms_per_frame": busy if measured else None,
        "device_ops_per_frame": count / n if measured else None,
        "device_ops_per_chunk":
            count / n * args.chunk if measured and args.chunk else None,
        "idle_share_profiled": 1.0 - busy / prof_wall if measured else None,
        "idle_share_steady": 1.0 - busy / wall if measured else None,
        "conv_int8_ms_per_frame": sum(
            ms for k, ms in per_kernel.items() if "conv_int8" in k) / n
        if measured else None}),
        flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({"phase": "kernels", "top_device_ms_per_frame": [
        [name[:80], ms / n] for name, ms in top]}), flush=True)
    if args.chunk:
        k3 = sum(ms for k, ms in per_kernel.items()
                 if "tracker_chunk" in k) / n if measured else None
        print(json.dumps({"phase": "tracker_stages",
                          "kernel3_ms_per_frame": k3,
                          **clocked_split(calls, k3)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

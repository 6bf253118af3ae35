"""Where the time of the per-frame path goes, on the card.

    python -m posebyte_tpu_torch.utils.profiling [--frames 32]

Runs PosePipeline (yolov8n-pose, 640 input, bf16, raw u8 ingest; the
trained 640 checkpoint) on synthetic 1280x720 frames, each frame through
process_frame and fetch_outputs, and prints JSON lines:
  steady      host wall ms per frame with the profiler off
  stages      per pipeline stage (the labels of PosePipeline._step): host
              ms, and device ms of the kernels launched inside it, per
              frame, from torch.profiler
  device      device busy ms per frame (sum of kernel and copy times), device
              operations per frame, and the idle share 1 - busy / wall,
              against the profiled and the unprofiled wall time
  kernels     the ten kernels with the most device time per frame
Device numbers come only from the profiler's CUDA activity; where it
records none they print as null ("not measured").
"""
from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

STAGES = ("letterbox", "model", "decode", "nms", "tracker", "outputs")


def _frames(n: int, width: int = 1280, height: int = 720, persons: int = 6,
            seed: int = 7):
    from .synthetic import SyntheticScene, render_frame
    scene = SyntheticScene(persons, width, height, seed=seed)
    return [render_frame(scene.step(), width, height) for _ in range(n)]


def _run(pipe, frames, w, h):
    for fr in frames:
        pipe.fetch_outputs(pipe.process_frame(fr), w, h)


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core import PipelineConfig
    from ..models import load_params
    from ..pipeline import PosePipeline

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs a CUDA card")

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    params, _ = load_params(os.path.join(
        root, "assets", "yolov8n-pose-synthetic640.safetensors"))
    pipe = PosePipeline(PipelineConfig(), params)
    W, H = 1280, 720
    frames = _frames(args.warmup + args.frames)
    _run(pipe, frames[:args.warmup], W, H)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    _run(pipe, frames[args.warmup:], W, H)
    wall = (time.perf_counter() - t0) * 1e3 / args.frames
    print(json.dumps({"phase": "steady", "frames": args.frames,
                      "wall_ms_per_frame": wall,
                      "card": torch.cuda.get_device_name(0)}), flush=True)

    pipe.reset()
    _run(pipe, frames[:args.warmup], W, H)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _run(pipe, frames[args.warmup:], W, H)
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
        "idle_share_profiled": 1.0 - busy / prof_wall if measured else None,
        "idle_share_steady": 1.0 - busy / wall if measured else None}),
        flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({"phase": "kernels", "top_device_ms_per_frame": [
        [name[:80], ms / n] for name, ms in top]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

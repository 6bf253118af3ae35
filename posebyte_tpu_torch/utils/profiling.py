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

Beside main, the JAX package's diagnostic helpers (its
utils/profiling.py:29-214), which the command line calls:
profile_tracker_stages (benchmark --stages) times each tracker stage as a
slice of its own and profile_frame_phases (demo --timing) the per-frame
path's preprocess / detect / track phases, through the functions the path
itself runs (Kernel 2 through ops.assignment.auction, Kernel 1 through
pose_nms), each slice by CUDA events and a synchronize on the card
(utils.timing.loop_ms). The slices pay a synchronize each, which the path
does not: read them as relative weights.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from collections import defaultdict

import numpy as np

STAGES = ("ingest", "letterbox", "model", "decode", "nms", "reid",
          "tracker", "outputs", "fetch")


@dataclasses.dataclass
class FrameTiming:
    """The demo loop's phase totals (reference: main.cpp:192-221)."""
    preprocess_ms: float = 0.0
    detect_ms: float = 0.0
    track_ms: float = 0.0
    total_ms: float = 0.0
    frames: int = 0

    def report(self) -> str:
        n = max(self.frames, 1)
        fps = 1000.0 * n / self.total_ms if self.total_ms else 0.0
        return (f"\n=== Timing breakdown ({self.frames} frames) ===\n"
                f"  Preprocess: {self.preprocess_ms / n:7.2f} ms/frame\n"
                f"  Detect:     {self.detect_ms / n:7.2f} ms/frame\n"
                f"  Track:      {self.track_ms / n:7.2f} ms/frame\n"
                f"  TOTAL:      {self.total_ms / n:7.2f} ms/frame "
                f"({fps:.1f} FPS)")


@dataclasses.dataclass
class TrackerTiming:
    """Per-stage tracker totals (reference: TrackerTiming,
    gpu_tracker.h:29-41)."""
    predict_us: float = 0.0
    gate_us: float = 0.0
    high_assoc_us: float = 0.0
    low_assoc_us: float = 0.0
    lost_assoc_us: float = 0.0
    update_us: float = 0.0
    age_us: float = 0.0
    new_track_us: float = 0.0
    dedup_us: float = 0.0
    total_us: float = 0.0
    frame_count: int = 0

    def print_stats(self):
        """printTimingStats (gpu_tracker.cu:1641-1658)."""
        if self.frame_count == 0:
            return
        n = float(self.frame_count)
        print(f"\n=== Tracker Timing Stats ({self.frame_count} frames) ===")
        for label, v in [("Predict", self.predict_us),
                         ("Spatial gate", self.gate_us),
                         ("High assoc", self.high_assoc_us),
                         ("Low assoc", self.low_assoc_us),
                         ("Lost assoc", self.lost_assoc_us),
                         ("Update", self.update_us),
                         ("Age tracks", self.age_us),
                         ("New tracks", self.new_track_us),
                         ("Dedup", self.dedup_us)]:
            print(f"  {label:13s} {v / n:8.2f} us/frame")
        print("  " + "-" * 29)
        print(f"  {'TOTAL':13s} {self.total_us / n:8.2f} us/frame "
              f"({1e6 * n / max(self.total_us, 1e-9):.1f} FPS potential)")


def profile_tracker_stages(state, det, config, iters: int = 20
                           ) -> TrackerTiming:
    """Per-stage tracker times by running each stage as a slice of its own
    on the state's device, `iters` times (stage boundaries of
    GPUTracker::update, SURVEY.md §3.2): predict, gate, the three auction
    tiers (Kernel 2 on the card, through ops.assignment.auction), update
    and the dedup matrix. The age and new-track stages stay 0, as in the
    JAX package."""
    import torch

    from ..core import constants as C
    from ..ops.assignment import auction
    from ..ops.gating import spatial_gate
    from ..ops.geometry import centers_iou_matrix, pose_centers
    from ..ops.kalman import cv_predict, cv_update
    from ..ops.oks import oks_matrix, torso_oks_matrix
    from .timing import loop_ms

    dev = state.poses.device
    t = TrackerTiming()
    with torch.inference_mode():
        predicted, vel = cv_predict(state.poses, state.velocities,
                                    state.active, state.states)
        tc = pose_centers(predicted)
        dc = pose_centers(det.poses)
        gate = spatial_gate(tc, dc, vel, state.active, state.states,
                            config.gate_threshold)
        cost = torch.where(gate, 1.0 - oks_matrix(
            predicted, det.poses, config.visibility_threshold), 1e9)
        lost = state.active & (state.states == C.TRACK_STATE_LOST)
        unmatched = torch.full((config.max_tracks,), -1, dtype=torch.int32,
                               device=dev)
        stages = {
            "predict_us": lambda: cv_predict(
                state.poses, state.velocities, state.active, state.states),
            "gate_us": lambda: spatial_gate(
                tc, dc, vel, state.active, state.states,
                config.gate_threshold),
            "high_assoc_us": lambda: auction(cost, state.active),
            "low_assoc_us": lambda: auction(torch.where(
                gate, 1.0 - torso_oks_matrix(predicted, det.poses), 1e9),
                state.active),
            "lost_assoc_us": lambda: auction(cost, lost),
            "update_us": lambda: cv_update(state.poses, vel, det.poses,
                                           unmatched, state.active),
            "dedup_us": lambda: centers_iou_matrix(tc),
        }
        total = 0.0
        for name, fn in stages.items():
            us = loop_ms(fn, iters, dev) * 1e3 * iters
            setattr(t, name, us)
            total += us
    t.total_us = total
    t.frame_count = iters
    return t


def profile_frame_phases(pipe, frame_h: int, frame_w: int,
                         iters: int = 10) -> FrameTiming:
    """The demo's preprocess / detect / track split (reference:
    main.cpp:298-303), each phase a slice of its own on the pipeline's
    device, `iters` times, on a seeded random frame of this geometry:
    the matmul letterbox; the model, decode and pose-NMS (Kernel 1 on the
    card); tracker_step (Kernel 2 three times on the card). total_ms is
    `iters` frames of the real per-frame step, process_frame, measured
    apart, after which the pipeline's state and timing are put back as
    they were (the JAX package leaves its tracks aged by these frames)."""
    import torch

    from ..core.structs import Detections, TrackerState
    from ..ops.decode import decode_topk
    from ..ops.nms import pose_nms
    from ..ops.preprocess import letterbox_flat_nhwc
    from ..tracker.step import tracker_step
    from .timing import loop_ms

    det_cfg, trk_cfg = pipe.config.detector, pipe.config.tracker
    S, dev = det_cfg.input_size, pipe.device
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.integers(
        0, 255, (frame_h * frame_w * 3,), dtype=np.uint8)).to(dev)

    def pre():
        return letterbox_flat_nhwc(flat, frame_w, frame_h, S,
                                   out_dtype=pipe.dtype,
                                   raw=det_cfg.raw_preproc)

    def detect(img):
        box, cls, kpt = pipe.detector.heads(pipe.params, img[None])
        d = decode_topk(box, cls, kpt, det_cfg.conf_threshold,
                        det_cfg.max_candidates, S,
                        topk_impl=det_cfg.topk_impl)
        d = pose_nms(d, det_cfg.iou_threshold, det_cfg.oks_threshold,
                     det_cfg.max_detections, presorted=True)
        return Detections(d.poses[0], d.boxes[0], d.scores[0], d.valid[0])

    with torch.inference_mode():
        img = pre()
        det = detect(img)
        state = TrackerState.init(trk_cfg.max_tracks, trk_cfg.max_detections,
                                  dev)
        t = FrameTiming(frames=iters)
        t.preprocess_ms = loop_ms(pre, iters, dev) * iters
        t.detect_ms = loop_ms(lambda: detect(img), iters, dev) * iters
        t.track_ms = loop_ms(lambda: tracker_step(state, det, trk_cfg),
                             iters, dev) * iters
    frame = np.zeros((frame_h, frame_w, 3), np.uint8)
    kept, timing = pipe.state, dict(pipe.timing)
    try:
        t.total_ms = loop_ms(lambda: pipe.process_frame(frame), iters,
                             dev) * iters
    finally:
        pipe.state, pipe.timing = kept, timing
    return t


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

"""benchmark on the port: component and pipeline micro-benchmarks, after
posebyte_tpu/cli/benchmark.py (reference: src/benchmark.cpp): the same
seeded human-shaped pose fixture (benchmark.cpp:19-66; numpy
default_rng(42), as the JAX package draws it), the same components at the
reference's shapes and the same result keys, on the CUDA card unless
--device cpu:

  kalman136_predict_ms, kalman136_update_ms   Kalman136 over 50 tracks
  oks_50x100_ms, torso_oks_50x100_ms          OKS matrices, 50 x 100
  auction_50x50_ms     Kernel 2 on a 50 x 50 cost (ops.assignment.auction)
  pose_nms_100_ms      pose_nms of 100 candidates (Kernel 1 through
                       ops.nms.nms_keep)
  tracker_step_ms      tracker_step with 5 people (Kernel 2 three times)
  e2e_<model>_ms       with -e: PosePipeline.process_frame on a 1280x720
                       frame, synchronised each frame

Each is the mean over -n calls issued back to back after one warm-up,
timed by CUDA events and a synchronize on the card
(utils.timing.loop_ms), by the host's clock on the CPU.

Usage:
  python -m posebyte_tpu_torch.cli.benchmark [-n ITERS] [-e MODEL] [--json]
      [--stages] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def generate_random_pose(rng, img_w=640, img_h=640,
                         scale_range=(50.0, 150.0)):
    """Procedural human-shaped skeleton (reference: benchmark.cpp:19-66),
    drawn from `rng` in the JAX package's order."""
    from ..utils.synthetic import POSE_OFFSETS
    cx = rng.uniform(100, img_w - 100)
    cy = rng.uniform(100, img_h - 100)
    s = rng.uniform(*scale_range)
    pose = np.zeros((17, 3), np.float32)
    pose[:, 0] = cx + POSE_OFFSETS[:, 0] * s
    pose[:, 1] = cy + POSE_OFFSETS[:, 1] * s
    pose[:, 2] = rng.uniform(0.5, 1.0, size=17)
    return pose


def fixture(device) -> dict:
    """The components' inputs on `device`, drawn from default_rng(42) in
    the JAX package's order: dets50 [50, 17, 3] (Kalman), tracks [50, 17,
    3] and dets100 [100, 17, 3] (OKS), cost [50, 50] (auction), nms
    (Detections of 100 candidates), det5 (Detections of capacity
    TrackerConfig().max_detections, 5 people), and the generator, for
    the end-to-end frame drawn after them."""
    import torch
    from ..core.config import TrackerConfig
    from ..core.structs import Detections

    rng = np.random.default_rng(42)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def poses(k):
        return np.stack([generate_random_pose(rng) for _ in range(k)])

    f = {"dets50": dev(poses(50))}
    f["tracks"], f["dets100"] = dev(poses(50)), dev(poses(100))
    f["cost"] = dev(rng.uniform(0, 1, (50, 50)).astype(np.float32))
    poses100 = poses(100)
    boxes = np.stack([[p[:, 0].min(), p[:, 1].min(), p[:, 0].max(),
                       p[:, 1].max()] for p in poses100]).astype(np.float32)
    f["nms"] = Detections(
        poses=dev(poses100), boxes=dev(boxes),
        scores=dev(rng.uniform(0.3, 1.0, 100).astype(np.float32)),
        valid=torch.ones((100,), dtype=torch.bool, device=device))
    D = TrackerConfig().max_detections
    p5 = np.zeros((D, 17, 3), np.float32)
    p5[:5] = poses(5)
    scores5 = np.zeros((D,), np.float32)
    scores5[:5] = 0.9
    f["det5"] = Detections(poses=dev(p5),
                           boxes=torch.zeros((D, 4), device=device),
                           scores=dev(scores5), valid=dev(scores5 > 0))
    f["rng"] = rng
    return f


def run(iters: int, device, engine: str = "", stages: bool = False) -> dict:
    """The benchmark's results {key: mean ms}; with `stages`, the tracker's
    per-stage times are printed (profile_tracker_stages)."""
    import torch
    from ..core.config import TrackerConfig
    from ..core.structs import KalmanState136, TrackerState
    from ..ops.assignment import auction
    from ..ops.kalman import Kalman136
    from ..ops.nms import pose_nms
    from ..ops.oks import oks_matrix, torso_oks_matrix
    from ..tracker.step import tracker_step
    from ..utils.timing import loop_ms

    from .demo import load_model_params
    loaded = load_model_params(engine) if engine else None
    f = fixture(device)
    n = iters
    results = {}
    with torch.inference_mode():
        # Kalman 136-D (reference: benchmarkKalmanFilter, 50 tracks)
        dets50 = f["dets50"]
        slots = torch.arange(50, dtype=torch.int32, device=device)
        valid = torch.ones((50,), dtype=torch.bool, device=device)
        kstate = Kalman136.initiate(KalmanState136.init(50, device), dets50,
                                    slots, valid)
        results["kalman136_predict_ms"] = loop_ms(
            lambda: Kalman136.predict(kstate), n, device)
        results["kalman136_update_ms"] = loop_ms(
            lambda: Kalman136.update(kstate, dets50, slots, slots, valid),
            n, device)

        # OKS distance (reference: benchmarkOKSDistance, 50 x 100)
        results["oks_50x100_ms"] = loop_ms(
            lambda: oks_matrix(f["tracks"], f["dets100"]), n, device)
        results["torso_oks_50x100_ms"] = loop_ms(
            lambda: torso_oks_matrix(f["tracks"], f["dets100"]), n, device)

        # Auction (reference: benchmarkHungarian, 50 x 50): Kernel 2
        results["auction_50x50_ms"] = loop_ms(lambda: auction(f["cost"]), n,
                                              device)

        # Pose NMS (reference: benchmarkNMS, 100 candidates): Kernel 1
        results["pose_nms_100_ms"] = loop_ms(
            lambda: pose_nms(f["nms"], 0.55, 0.55, 64), n, device)

        # Full tracker (reference: benchmarkGPUTracker, 5 persons)
        cfg = TrackerConfig()
        det5 = f["det5"]
        state = [TrackerState.init(cfg.max_tracks, cfg.max_detections,
                                   device)]

        def step():
            state[0], _ = tracker_step(state[0], det5, cfg)
        results["tracker_step_ms"] = loop_ms(step, n, device)

    if loaded is not None:
        from ..core.config import PipelineConfig
        from ..core.device import set_numeric_settings
        from ..pipeline import PosePipeline
        set_numeric_settings()
        params, name = loaded
        pipe = PosePipeline(PipelineConfig(model_name=name), params=params,
                            device=device)
        frame = f["rng"].integers(0, 255, (720, 1280, 3), dtype=np.uint8)
        for _ in range(3):
            pipe.process_frame(frame, block=True)
        t0 = time.perf_counter()
        for _ in range(n):
            pipe.process_frame(frame, block=True)
        results[f"e2e_{name}_ms"] = (time.perf_counter() - t0) / n * 1e3

    if stages:
        from ..utils.profiling import profile_tracker_stages
        profile_tracker_stages(state[0], det5, cfg, iters=n).print_stats()
    return results


def main(argv=None):
    from .demo import add_device_flag, resolve
    p = argparse.ArgumentParser(prog="benchmark")
    p.add_argument("-n", "--iterations", type=int, default=100)
    p.add_argument("-e", "--engine", default="",
                   help="also benchmark this model end to end (weights "
                        "path: .safetensors or .pt)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line instead of a table")
    p.add_argument("--stages", action="store_true",
                   help="also print per-stage tracker timing "
                        "(printTimingStats)")
    add_device_flag(p)
    args = p.parse_args(argv)
    device = resolve(args.device)
    results = run(args.iterations, device, args.engine, args.stages)
    if args.json:
        print(json.dumps({k: round(v, 4) for k, v in results.items()}))
    else:
        import torch
        name = torch.cuda.get_device_name(device) \
            if device.type == "cuda" else "cpu"
        print(f"\n=== PoseBYTE benchmark ({args.iterations} iters, "
              f"{name}) ===")
        for k, v in results.items():
            print(f"  {k:28s} {v:9.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving throughput of StreamServer and ChunkedStreamServer on the card:
every one of S streams fed W x H synthetic frames (the port's renderer,
seeded), each server stepped until drained, every step timed on the host
clock (a step ends with its outputs' copy to the host). Prints one JSON
line per server and round.

    python -m posebyte_tpu_torch.utils.serving_rate [--ckpt F] \\
        [--streams 8] [--frames 32] [--chunk 8] [--rounds 2]

It calls the servers' public API only, so a copy of this file placed in
another checkout of the package measures that checkout's servers: run
both in one process's turn order (A, B, B, A) to compare two trees.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")


def render_streams(n: int, frames: int, w: int, h: int, seed: int):
    """n streams of `frames` frames each, one synthetic scene of six people
    per stream, sized for 1080p as chip_smoke's serving phases draw them."""
    from ..utils.synthetic import SyntheticScene, render_frame
    out = []
    for s in range(n):
        scene = SyntheticScene(6, w, h, seed=seed + 100 + s,
                               scale_range=(135.0, 210.0), speed=6.0)
        out.append(np.stack([render_frame(scene.step(), w, h)
                             for _ in range(frames)]))
    return out


def serve(srv, streams) -> dict:
    """Open every stream, queue all its frames, step until drained.
    Returns the wall ms of each step and the frames each step served."""
    import torch
    for sid, frames in enumerate(streams):
        if srv.open_stream() != sid:
            raise RuntimeError("slots are not handed out in order")
        for f in frames:
            srv.submit(sid, f)
    ms, served = [], []
    torch.cuda.synchronize()
    while True:
        t = time.perf_counter()
        n = srv.step()
        if n == 0:
            break
        ms.append((time.perf_counter() - t) * 1e3)
        served.append(n)
    for sid in range(len(streams)):
        srv.poll(sid)
        srv.close_stream(sid)
    return {"ms": ms, "served": served}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default=os.path.join(
        ASSETS, "yolov8n-pose-synthetic640.safetensors"))
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--frames", type=int, default=32,
                    help="frames per stream and round")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    import torch
    from ..core import PipelineConfig
    from ..models import load_params
    from ..pipeline import ChunkedStreamServer, StreamServer
    if not torch.cuda.is_available():
        print("serving_rate: no CUDA device")
        return 1
    params, _ = load_params(args.ckpt)
    streams = render_streams(args.streams, args.frames, args.width,
                             args.height, args.seed)
    shape = (args.height, args.width)
    servers = {
        "frame": StreamServer(args.streams, shape, PipelineConfig(), params),
        "chunk": ChunkedStreamServer(args.streams, shape, args.chunk,
                                     PipelineConfig(), params)}
    for kind, srv in servers.items():
        serve(srv, [s[:getattr(srv, "chunk", 1)] for s in streams])  # warm
        for r in range(args.rounds):
            run = serve(srv, streams)
            # the first step resets every slot; the rate is over the rest
            ms, served = run["ms"][1:], run["served"][1:]
            print(json.dumps({
                "tag": args.tag, "server": kind, "round": r,
                "streams": args.streams, "frame": [args.width, args.height],
                "chunk": getattr(srv, "chunk", 1), "steps": len(run["ms"]),
                "frames_per_s": sum(served) / (sum(ms) / 1e3),
                "median_ms_per_step": statistics.median(ms),
                "ms_first_step": run["ms"][0], "ms_per_step": ms}),
                flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

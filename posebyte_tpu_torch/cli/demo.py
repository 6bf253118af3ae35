"""posebyte_demo on the port: real-time pose tracking on a video, after
posebyte_tpu/cli/demo.py (reference: src/main.cpp:70-311): the same flags,
the same tracker thresholds from the confidence (low = conf * 0.5,
new_track = conf, main.cpp:132-141), the same per-frame or chunked loop
and the same summary, with --device (the CUDA card unless "cpu").

Usage:
  python -m posebyte_tpu_torch.cli.demo -e model.safetensors -i in.mp4 \\
      [-o out.mp4] [-c 0.30] [-n 0.65] [-t 0.5] [-a 10] [-d] [-v] \\
      [--chunk K] [--device cpu]

Reading and writing video needs cv2 (utils/video.py); track_frames runs
the loop on frames from anywhere.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# Where each refusal's missing piece is queued (ROADMAP.md, Queue 1).
ROADMAP_TRAINING = "ROADMAP Queue 1, 'Training' (init_params)"
ROADMAP_DECODE = "ROADMAP Queue 1, 'Decode variants'"
ROADMAP_ENGINE = "ROADMAP Queue 1, 'Engine and legacy NMS'"


def build_parser():
    p = argparse.ArgumentParser(
        prog="posebyte_demo",
        description="multi-person pose tracking on a CUDA card")
    p.add_argument("-e", "--engine", required=True,
                   help="model weights (.safetensors from export, or an "
                        "Ultralytics .pt)")
    p.add_argument("-i", "--input", required=True, help="input video")
    p.add_argument("-o", "--output", default="", help="output video")
    p.add_argument("-c", "--conf", type=float, default=0.30,
                   help="detection confidence threshold")
    p.add_argument("-n", "--nms", type=float, default=0.65,
                   help="NMS IoU threshold")
    p.add_argument("-t", "--track", type=float, default=0.5,
                   help="match cost threshold (1 - OKS)")
    p.add_argument("-a", "--max-age", type=int, default=10,
                   help="frames before a track is lost")
    p.add_argument("-d", "--display", action="store_true",
                   help="display output in a window (cv2)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-frame track dumps")
    p.add_argument("--precision", default="bf16",
                   choices=["fp32", "bf16", "int8"])
    p.add_argument("--size", type=int, default=640,
                   help="model input size (e.g. 256 for the "
                        "synthetic-trained checkpoint)")
    p.add_argument("--chunk", type=int, default=0,
                   help="process N frames per dispatch (batched detector "
                        "+ Kernel 3 over the chunk; 0 = per frame)")
    p.add_argument("--reid", type=float, default=0.0, metavar="W",
                   help="appearance Re-ID blend weight 0..1 (0 = "
                        "geometric association only)")
    p.add_argument("--reid-weights", default="", metavar="PATH",
                   help="learned Re-ID head checkpoint; replaces the "
                        "pose-colour descriptor when --reid > 0")
    p.add_argument("--motion-model", default="cv",
                   choices=["cv", "kalman136"],
                   help="tracker motion model")
    p.add_argument("--save-state", default="",
                   help="write the tracker state here at exit")
    p.add_argument("--resume-state", default="",
                   help="resume from a tracker-state checkpoint (of "
                        "either package)")
    p.add_argument("--topk-impl", default="sort",
                   choices=["sort", "bisect", "approx"],
                   help="decode candidate ranking (the port runs 'sort')")
    p.add_argument("--gather-impl", default="onehot",
                   choices=["index", "onehot"],
                   help="decode candidate-row extraction (equal values; "
                        "the port gathers by index for both)")
    p.add_argument("--timing", action="store_true",
                   help="print a preprocess/detect/track breakdown after "
                        "the run (reference: main.cpp:298-303)")
    add_device_flag(p)
    return p


def add_device_flag(p):
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the CUDA card) or 'cpu'")


def resolve(device):
    """The CLI's device: resolve_device, with its refusal as the exit
    message (no card and no --device cpu)."""
    from ..core.device import resolve_device
    try:
        return resolve_device(device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from e


def refuse_topk(impl: str):
    if impl != "sort":
        raise SystemExit(f"--topk-impl {impl}: the port ranks candidates "
                         f"by 'sort' only ({ROADMAP_DECODE})")


def load_model_params(engine: str):
    """Resolve the -e argument: .safetensors | Ultralytics .pt ->
    (params, model name). A bare model name, which the JAX package
    initialises with random weights, is refused: the port has no
    init_params yet."""
    from ..models import MODEL_CONFIGS
    from ..models.weights import load_params, load_pretrained
    if engine in MODEL_CONFIGS:
        raise SystemExit(f"{engine}: random-weight models need init_params, "
                         f"which the port lacks ({ROADMAP_TRAINING}); pass "
                         "a .safetensors or .pt checkpoint")
    if engine.endswith(".safetensors"):
        return load_params(engine)
    if engine.endswith((".pt", ".pth")):
        for name in MODEL_CONFIGS:
            if name.split("-")[0] in engine:
                return load_pretrained(engine, name), name
        raise SystemExit(
            f"cannot infer model size from {engine}; rename to include "
            f"e.g. 'yolov8n'")
    raise SystemExit(f"unrecognized engine: {engine}")


def track_frames(pipe, frames, width: int, height: int, chunk: int = 0):
    """Yield (frame, tracks) for every BGR uint8 frame of the iterable
    `frames`: per frame (process_frame + fetch_outputs), or with chunk > 1
    in chunks of `chunk` frames (process_chunk + fetch_chunk_outputs, one
    copy to the host a chunk), the tail that fills no chunk per frame, as
    the JAX demo runs it."""
    if chunk <= 1:
        for frame in frames:
            yield frame, pipe.fetch_outputs(pipe.process_frame(frame),
                                            width, height)
        return
    buf = []
    for frame in frames:
        buf.append(frame)
        if len(buf) == chunk:
            outs = pipe.process_chunk(np.stack(buf))
            yield from zip(buf, pipe.fetch_chunk_outputs(outs, width,
                                                         height))
            buf = []
    for frame in buf:
        yield frame, pipe.fetch_outputs(pipe.process_frame(frame), width,
                                        height)


def main(argv=None):
    args = build_parser().parse_args(argv)
    refuse_topk(args.topk_impl)
    device = resolve(args.device)

    from ..core.config import DetectorConfig, PipelineConfig, TrackerConfig
    from ..core.device import set_numeric_settings
    from ..pipeline import PosePipeline
    from ..utils.video import (PrefetchVideoReader, VideoWriter,
                               draw_all_tracks, draw_stats)

    set_numeric_settings()
    params, model_name = load_model_params(args.engine)
    print(f"Loading model: {model_name} (pretrained)")

    tracker_cfg = TrackerConfig(
        match_threshold=args.track,
        high_thresh=args.conf,
        low_thresh=args.conf * 0.5,
        new_track_thresh=args.conf,
        max_age=args.max_age,
        motion_model=args.motion_model,
        reid_weight=args.reid,
    )
    num_anchors = sum((args.size // s) ** 2 for s in (8, 16, 32))
    config = PipelineConfig(
        detector=DetectorConfig(conf_threshold=args.conf,
                                iou_threshold=args.nms,
                                input_size=args.size,
                                num_anchors=num_anchors,
                                topk_impl=args.topk_impl,
                                gather_impl=args.gather_impl),
        tracker=tracker_cfg,
        model_name=model_name,
        precision=args.precision,
    )
    reid_params = None
    if args.reid_weights:
        from ..models.reid_head import load_reid_head
        reid_params = load_reid_head(args.reid_weights)
        print(f"Loaded learned Re-ID head: {args.reid_weights}")
    pipe = PosePipeline(config, params=params, device=device,
                        reid_params=reid_params)
    print(f"Tracker initialized (max {tracker_cfg.max_tracks} tracks, "
          f"{tracker_cfg.max_detections} detections)")
    if args.resume_state:
        from ..utils.checkpoint import load_tracker_state
        pipe.state = load_tracker_state(args.resume_state, device)
        print(f"Resumed tracker state from {args.resume_state} "
              f"(frame {int(pipe.state.frame)}, "
              f"next id {int(pipe.state.next_id)})")

    video = PrefetchVideoReader(args.input)   # decode overlaps dispatch
    print(f"Video info: {video.width}x{video.height} @ {video.fps:.1f} fps, "
          f"{video.frame_count} frames")
    writer = None
    if args.output:
        writer = VideoWriter(args.output, video.width, video.height,
                             video.fps)
        print(f"Writing output to: {args.output}")

    frame_idx = 0
    t_start = time.perf_counter()
    fps_smooth = 0.0
    gen = track_frames(pipe, video, video.width, video.height, args.chunk)
    while True:
        t0 = time.perf_counter()
        try:
            frame, tracks = next(gen)
        except StopIteration:
            break
        dt = time.perf_counter() - t0
        fps_smooth = 0.9 * fps_smooth + 0.1 / max(dt, 1e-6) \
            if fps_smooth else 1.0 / max(dt, 1e-6)
        frame_idx += 1

        if args.verbose:
            ids = [t.track_id for t in tracks]
            print(f"frame {frame_idx}: {len(tracks)} tracks, ids={ids}")

        if writer is not None or args.display:
            draw_all_tracks(frame, tracks)
            draw_stats(frame, fps_smooth, len(tracks), dt * 1e3)
        if writer is not None:
            writer.write(frame)
        if args.display:
            from ..utils.video import _cv2
            cv2 = _cv2()
            cv2.imshow("posebyte", frame)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
        if not args.verbose and frame_idx % 30 == 0:
            total = video.frame_count or 0
            print(f"\r  frame {frame_idx}/{total}  {fps_smooth:6.1f} FPS",
                  end="", flush=True)

    total_s = time.perf_counter() - t_start
    print("\n\n=== Summary ===")
    print(f"Frames processed: {frame_idx}")
    print(f"Total time:       {total_s:.2f} s")
    if frame_idx:
        print(f"Average FPS:      {frame_idx / total_s:.1f}")
        print(f"Mean dispatch:    {pipe.mean_frame_ms:.2f} ms/frame")
    if args.timing and frame_idx:
        from ..utils.profiling import profile_frame_phases
        timing = profile_frame_phases(pipe, video.height, video.width,
                                      iters=10)
        print("[diagnostic re-measurement of phase slices; not an "
              "accounting of the run above]")
        print(timing.report())
    if args.save_state:
        from ..utils.checkpoint import save_tracker_state
        save_tracker_state(pipe.state, args.save_state)
        print(f"Saved tracker state to {args.save_state}")
    video.release()
    if writer is not None:
        writer.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""evaluate on the port: score the tracking pipeline against ground truth,
after posebyte_tpu/cli/evaluate.py: the same flags (with --device) and the
same JSON line. It runs the pipeline over a video and scores it against a
ground-truth .npz (`poses` [F, P, 17, 3] in frame pixels, as
scripts/make_test_video.py --gt writes it): OKS-mAP for detection, MOTA,
IDF1 and id switches for tracking (utils/evaluation.py).

Usage:
  python -m posebyte_tpu_torch.cli.evaluate -e yolov8n.safetensors \\
      -i video.mp4 -g gt.npz [-c 0.30] [--oks 0.5] [--warmup 3] [--json] \\
      [--chunk K] [--device cpu]

Reading the video needs cv2; evaluate_tracks scores frames from anywhere.
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np


def build_parser():
    from .demo import add_device_flag
    p = argparse.ArgumentParser(
        prog="posebyte_evaluate",
        description="score tracking output against ground truth")
    p.add_argument("-e", "--engine", required=True,
                   help="model weights (.safetensors / .pt)")
    p.add_argument("-i", "--input", required=True, help="input video")
    p.add_argument("-g", "--gt", required=True,
                   help="ground-truth .npz (poses [F,P,17,3])")
    p.add_argument("-c", "--conf", type=float, default=0.30)
    p.add_argument("--oks", type=float, default=0.5,
                   help="OKS threshold for GT matching")
    p.add_argument("--warmup", type=int, default=3,
                   help="frames excluded from MOTA while tracks confirm "
                        "(min_hits warmup)")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--size", type=int, default=640,
                   help="model input size")
    p.add_argument("--chunk", type=int, default=0,
                   help="evaluate in N-frame chunks (Kernel 3 over each "
                        "chunk)")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line instead of a report")
    add_device_flag(p)
    return p


def evaluate_tracks(pipe, frames, gt_poses, width: int, height: int,
                    warmup: int = 3, oks: float = 0.5, chunk: int = 0,
                    max_frames: int = 0, gt_active=None,
                    record: list | None = None) -> dict:
    """Track the BGR uint8 frames of the iterable `frames` through `pipe`
    (demo.track_frames: per frame, or in chunks of `chunk`) and score
    frame n against gt_poses[n] ([P, 17, 3] in frame pixels): MOTA, IDF1,
    misses, false positives and id switches from frame `warmup` on, with
    ground-truth id i for person i; OKS-mAP, AP50 and AP75 over every
    frame. At most len(gt_poses) frames, and at most max_frames when it is
    set. gt_active: optional [F, P] bool, the people present in each frame
    (a CrowdedScene's), the others left out of both scores. record: an
    optional list that receives each frame's tracks. Returns
    {"frames", the TrackingEvaluator summary, "mAP", "AP50", "AP75"}, the
    last three rounded to 4 places as the CLI prints them."""
    from ..utils.evaluation import TrackingEvaluator, keypoint_map
    from .demo import track_frames

    limit = len(gt_poses) if not max_frames else min(len(gt_poses),
                                                     max_frames)
    ev = TrackingEvaluator(oks_threshold=oks)
    det_gt, det_pred, det_scores = [], [], []
    n = 0
    for _, tracks in track_frames(pipe, itertools.islice(frames, limit),
                                  width, height, chunk):
        if record is not None:
            record.append(tracks)
        gt_f = np.asarray(gt_poses[n])
        if gt_active is not None:
            gt_f = {i: gt_f[i] for i in np.flatnonzero(gt_active[n])}
        else:
            gt_f = {i: gt_f[i] for i in range(len(gt_f))}
        if n >= warmup:
            ev.update(gt_f, tracks)
        det_gt.append(np.stack(list(gt_f.values())) if gt_f
                      else np.zeros((0, 17, 3), np.float32))
        det_pred.append(np.stack([t.keypoints for t in tracks])
                        if tracks else np.zeros((0, 17, 3), np.float32))
        det_scores.append(np.asarray([t.score for t in tracks],
                                     np.float32))
        n += 1
    if n == 0:
        return {"frames": 0}
    maps = keypoint_map(det_gt, det_pred, det_scores)
    return {"frames": n, **ev.summary(),
            **{k: round(v, 4) for k, v in maps.items()}}


def main(argv=None):
    from .demo import load_model_params, resolve
    args = build_parser().parse_args(argv)
    device = resolve(args.device)

    from ..core.config import DetectorConfig, PipelineConfig, TrackerConfig
    from ..core.device import set_numeric_settings
    from ..pipeline import PosePipeline
    from ..utils.video import VideoReader

    gt_poses = np.load(args.gt)["poses"]                 # [F, P, 17, 3]
    set_numeric_settings()
    params, model_name = load_model_params(args.engine)
    num_anchors = sum((args.size // s) ** 2 for s in (8, 16, 32))
    config = PipelineConfig(
        detector=DetectorConfig(conf_threshold=args.conf,
                                input_size=args.size,
                                num_anchors=num_anchors),
        tracker=TrackerConfig.from_conf_threshold(args.conf),
        model_name=model_name,
    )
    pipe = PosePipeline(config, params=params, device=device)
    video = VideoReader(args.input)
    try:
        summary = evaluate_tracks(pipe, video, gt_poses, video.width,
                                  video.height, args.warmup, args.oks,
                                  args.chunk, args.max_frames)
    finally:
        video.release()
    n = summary["frames"]
    if n == 0:
        print("no frames evaluated", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"\n=== Evaluation ({n} frames vs {args.gt}) ===")
        print(f"  OKS-mAP:        {summary['mAP']:.4f} "
              f"(AP50 {summary['AP50']:.4f}, AP75 {summary['AP75']:.4f})")
        print(f"  MOTA:           {summary['MOTA']:.4f}")
        print(f"  id switches:    {summary['id_switches']}")
        print(f"  misses:         {summary['misses']} / {summary['gt']} GT")
        print(f"  false positives:{summary['false_positives']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

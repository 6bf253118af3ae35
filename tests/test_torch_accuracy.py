"""The accuracy loop through the port alone, on the CPU: the trained
checkpoint tracked from pixels by cli.evaluate's loop function
(evaluate_tracks), against the JAX package's own bars:

- the n256 case of tests/test_trained_pixels.py (yolov8n-pose at 256, the
  held-out clip: seed 424242, 3 people, 640x360, 48 frames, fp32): OKS-mAP
  >= 0.90, MOTA >= 0.95, at most 1 id switch;
- the crowded hard clip of tests/test_hard_tracking.py:125 (CrowdedScene
  seed 86002, 8 people crossing, entering and leaving, 96 frames, detector
  confidence 0.15, tracker thresholds from 0.30): MOTA >= 0.51, IDF1 >=
  0.47, at most 29 id switches.

Each clip twice: rendered by the JAX package's cv2 renderer (the frames its
bars were measured on), and by the port's numpy renderer, which differs by
a few edge pixels and is what the card's host, which has no cv2, renders.
The bars are the JAX package's, unchanged, for both.
"""
import os

import numpy as np
import pytest
import torch

from posebyte_tpu.utils.synthetic import render_frame as cv2_render

from posebyte_tpu_torch.cli.evaluate import evaluate_tracks
from posebyte_tpu_torch.core import (DetectorConfig, PipelineConfig,
                                     TrackerConfig)
from posebyte_tpu_torch.models import load_params
from posebyte_tpu_torch.pipeline import PosePipeline
from posebyte_tpu_torch.utils import synthetic as S

torch.set_num_threads(4)

ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "yolov8n-pose-synthetic256.safetensors")
W, H, SIZE = 640, 360, 256
RENDERERS = {"cv2": cv2_render, "port": S.render_frame}


def _pipeline(conf=0.30, det_conf=None):
    params, name = load_params(ASSET)
    num_anchors = sum((SIZE // s) ** 2 for s in (8, 16, 32))
    config = PipelineConfig(
        detector=DetectorConfig(input_size=SIZE, num_anchors=num_anchors,
                                conf_threshold=det_conf or conf),
        tracker=TrackerConfig.from_conf_threshold(conf),
        model_name=name, precision="fp32")
    return PosePipeline(config, params, device="cpu")


@pytest.mark.parametrize("renderer", list(RENDERERS))
def test_trained_n256_tracks_people_from_pixels(renderer):
    scene = S.SyntheticScene(n_persons=3, width=W, height=H, seed=424242,
                             scale_range=(80.0, 130.0), speed=4.0)
    gts = [g.copy() for g in scene.frames(48)]
    frames = [RENDERERS[renderer](g, W, H) for g in gts]
    pipe = _pipeline()
    s = evaluate_tracks(pipe, frames, gts, W, H,
                        warmup=pipe.config.tracker.min_hits)
    assert s["frames"] == 48
    assert s["mAP"] >= 0.90, s
    assert s["MOTA"] >= 0.95, s
    assert s["id_switches"] <= 1, s


@pytest.mark.parametrize("renderer", list(RENDERERS))
def test_hard_clip_bars(renderer):
    n = 96
    scene = S.CrowdedScene(n_persons=8, width=W, height=H, seed=86002,
                           scale_range=(80.0, 130.0), speed=5.0,
                           entry_exit=True, clip_len=n)
    gts = [(p.copy(), a.copy()) for p, a in scene.frames(n)]
    palette = np.asarray([(60 + (60 * i) % 196, 200, 255 - (50 * i) % 200)
                          for i in range(8)])
    frames = [RENDERERS[renderer](p[a], W, H, colors=palette[a])
              for p, a in gts]
    pipe = _pipeline(conf=0.30, det_conf=0.15)
    s = evaluate_tracks(pipe, frames, [p for p, _ in gts], W, H,
                        warmup=pipe.config.tracker.min_hits,
                        gt_active=[a for _, a in gts])
    assert s["frames"] == n
    assert s["MOTA"] >= 0.51, s
    assert s["IDF1"] >= 0.47, s
    assert s["id_switches"] <= 29, s

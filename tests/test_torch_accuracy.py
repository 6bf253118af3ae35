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

And the hard clip with the learned Re-ID head
(assets/reid-head-synthetic, reid_weight 0.3) on the cv2 frames, the
configuration of EVAL_HARD_r05.json's "reid03_learned": the port's ids
equal to the JAX package's PosePipeline's in every frame, and its MOTA and
IDF1 those of that file's seed 86002.
"""
import json
import dataclasses
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


def _hard_clip(renderer, n=96):
    """The crowded clip's ground truth [(poses, active)] and frames."""
    scene = S.CrowdedScene(n_persons=8, width=W, height=H, seed=86002,
                           scale_range=(80.0, 130.0), speed=5.0,
                           entry_exit=True, clip_len=n)
    gts = [(p.copy(), a.copy()) for p, a in scene.frames(n)]
    palette = np.asarray([(60 + (60 * i) % 196, 200, 255 - (50 * i) % 200)
                          for i in range(8)])
    frames = [RENDERERS[renderer](p[a], W, H, colors=palette[a])
              for p, a in gts]
    return gts, frames


@pytest.mark.parametrize("renderer", list(RENDERERS))
def test_hard_clip_bars(renderer):
    n = 96
    gts, frames = _hard_clip(renderer, n)
    pipe = _pipeline(conf=0.30, det_conf=0.15)
    s = evaluate_tracks(pipe, frames, [p for p, _ in gts], W, H,
                        warmup=pipe.config.tracker.min_hits,
                        gt_active=[a for _, a in gts])
    assert s["frames"] == n
    assert s["MOTA"] >= 0.51, s
    assert s["IDF1"] >= 0.47, s
    assert s["id_switches"] <= 29, s


def test_hard_clip_learned_reid_head_ids_match_jax():
    import jax.numpy as jnp
    from posebyte_tpu.core import config as JC
    from posebyte_tpu.models.reid_head import load_reid_head as j_head
    from posebyte_tpu.pipeline import PosePipeline as JPosePipeline
    from posebyte_tpu_torch.models import load_reid_head

    from test_torch_quant import jax_tree

    head = os.path.join(os.path.dirname(ASSET), "reid-head-synthetic"
                        ".safetensors")
    gts, frames = _hard_clip("cv2")
    pipe = _pipeline(conf=0.30, det_conf=0.15)
    cfg = dataclasses.replace(pipe.config, tracker=TrackerConfig
                              .from_conf_threshold(0.30, reid_weight=0.3))
    params, name = load_params(ASSET)
    pipe = PosePipeline(cfg, params, device="cpu",
                        reid_params=load_reid_head(head))
    jcfg = JC.PipelineConfig(
        detector=JC.DetectorConfig(**dataclasses.asdict(cfg.detector)),
        tracker=JC.TrackerConfig.from_conf_threshold(0.30, reid_weight=0.3),
        model_name=name, precision="fp32")
    jpipe = JPosePipeline(jcfg, jax_tree(params, name), dtype=jnp.float32,
                          reid_params=j_head(head))
    for i, frame in enumerate(frames):
        mine = pipe.fetch_outputs(pipe.process_frame(frame), W, H)
        theirs = jpipe.fetch_outputs(jpipe.process_frame(frame), W, H)
        assert [t.track_id for t in mine] == \
            [t.track_id for t in theirs], i
    pipe.reset()
    s = evaluate_tracks(pipe, frames, [p for p, _ in gts], W, H,
                        warmup=pipe.config.tracker.min_hits,
                        gt_active=[a for _, a in gts])
    with open(os.path.join(os.path.dirname(os.path.dirname(ASSET)),
                           "EVAL_HARD_r05.json")) as f:
        record = json.load(f)
    row = record["configs"]["reid03_learned"]
    seed = record["seeds"].index(86002)
    assert abs(s["MOTA"] - row["MOTA_per_seed"][seed]) < 1e-4, s
    assert abs(s["IDF1"] - row["IDF1_per_seed"][seed]) < 1e-4, s

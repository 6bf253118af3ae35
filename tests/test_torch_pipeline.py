"""Port's per-frame pipeline (posebyte_tpu_torch/pipeline/runner.py) against
the JAX PosePipeline: yolov8n-pose at input 256 with the trained 256
checkpoint, fp32, raw u8 ingest, on synthetic 1280x720 frames drawn by the
port's numpy rasteriser. Track ids must be equal frame by frame; keypoints
within 1e-2 px (fp32 convolutions of XLA and oneDNN differ in summation
order, ~1e-6 relative at the heads).
"""
import os

import numpy as np
import pytest
import torch

from posebyte_tpu.core.config import DetectorConfig as JDetectorConfig
from posebyte_tpu.core.config import PipelineConfig as JPipelineConfig
from posebyte_tpu.models.weights import load_params as j_load_params
from posebyte_tpu.pipeline import PosePipeline as JPosePipeline

from posebyte_tpu_torch.core.config import DetectorConfig, PipelineConfig
from posebyte_tpu_torch.core.device import resolve_device
from posebyte_tpu_torch.models import load_params
from posebyte_tpu_torch.pipeline import PosePipeline
from posebyte_tpu_torch.utils.synthetic import SyntheticScene, render_frame

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "yolov8n-pose-synthetic256.safetensors")
W, H = 1280, 720


def frames(n, seed=11, persons=4):
    scene = SyntheticScene(persons, W, H, seed=seed)
    return [render_frame(scene.step(), W, H) for _ in range(n)]


def test_pipeline_matches_jax():
    det = dict(input_size=256, num_anchors=1344)
    jpipe = JPosePipeline(JPipelineConfig(detector=JDetectorConfig(**det),
                                          precision="fp32"),
                          params=j_load_params(ASSET)[0])
    tpipe = PosePipeline(PipelineConfig(detector=DetectorConfig(**det),
                                        precision="fp32"),
                         params=load_params(ASSET)[0], device="cpu")
    n_tracks = []
    for fr in frames(5):
        jt = jpipe.fetch_outputs(jpipe.process_frame(fr), W, H)
        out = tpipe.process_frame(fr)
        tt = tpipe.fetch_outputs(out, W, H)
        assert [t.track_id for t in tt] == [t.track_id for t in jt]
        for a, b in zip(tt, jt):
            np.testing.assert_allclose(a.keypoints, b.keypoints, atol=1e-2)
            np.testing.assert_allclose(a.bbox, b.bbox, atol=1e-2)
        n_tracks.append(len(tt))
    assert n_tracks[-1] >= 3                 # the people are tracked
    assert int(tpipe.state.frame) == 5 and tpipe.timing["frames"] == 5
    tpipe.reset()
    assert int(tpipe.state.frame) == 0 and not tpipe.state.active.any()


def test_card_is_the_default_device():
    """With no device named the port runs on the card, and raises where
    there is none; it never moves to the CPU on its own."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        PosePipeline(PipelineConfig(), params=load_params(ASSET)[0])


def test_pipeline_rejects_unported_options():
    """Every option is ported: decode_fusion='tail' (the per-level head
    maps, tests/test_torch_decode_variants.py) and raw_preproc=False (the
    normalised letterbox into the unfolded model) both construct and
    run."""
    params = load_params(ASSET)[0]
    pipe = PosePipeline(PipelineConfig(detector=DetectorConfig(
        decode_fusion="tail")), params=params, device="cpu")
    assert pipe.detector.head_maps is not None
    pipe = PosePipeline(PipelineConfig(detector=DetectorConfig(
        raw_preproc=False)), params=params, device="cpu")
    assert not pipe.config.detector.raw_preproc
    assert pipe.detector.head_maps is None

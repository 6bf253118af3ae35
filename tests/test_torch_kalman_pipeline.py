"""PosePipeline with TrackerConfig(motion_model="kalman136") on the CPU
against the JAX PosePipeline (its lax.scan path on the CPU backend), per
chunk and per frame, with and without Re-ID (the pose-colour descriptor):
the trained 256 checkpoint, fp32, 1280x720 frames of the synthetic scene
(mirroring tests/test_pipeline.py::test_chunk_mode_kalman136_fallback at
the sizes of tests/test_torch_chunk_pipeline.py).

Tolerances: track ids, emit and num_active equal; keypoints, boxes,
scores and the state's filter (kf_mean, kf_cov) within 1e-2 (XLA's and
oneDNN's fp32 convolutions sum in different orders: the bar of
tests/test_torch_chunk_pipeline.py).
"""
import os

import jax
import numpy as np
import pytest
import torch

from posebyte_tpu.core.config import DetectorConfig as JDetectorConfig
from posebyte_tpu.core.config import PipelineConfig as JPipelineConfig
from posebyte_tpu.core.config import TrackerConfig as JTrackerConfig
from posebyte_tpu.models.weights import load_params as j_load_params
from posebyte_tpu.pipeline import PosePipeline as JPosePipeline

from posebyte_tpu_torch.core.config import DetectorConfig, PipelineConfig, \
    TrackerConfig
from posebyte_tpu_torch.models import load_params
from posebyte_tpu_torch.pipeline import PosePipeline
from posebyte_tpu_torch.utils.synthetic import SyntheticScene, render_frame

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "yolov8n-pose-synthetic256.safetensors")
DET = dict(input_size=256, num_anchors=1344)


def _pipelines(reid: bool):
    trk = dict(motion_model="kalman136", reid_weight=0.3 if reid else 0.0)
    jpipe = JPosePipeline(
        JPipelineConfig(detector=JDetectorConfig(**DET),
                        tracker=JTrackerConfig(**trk), precision="fp32"),
        params=j_load_params(ASSET)[0])
    tpipe = PosePipeline(
        PipelineConfig(detector=DetectorConfig(**DET),
                       tracker=TrackerConfig(**trk), precision="fp32"),
        params=load_params(ASSET)[0], device="cpu")
    return jpipe, tpipe


def _frames(n, seed=19):
    scene = SyntheticScene(4, 1280, 720, seed=seed)
    return np.stack([render_frame(scene.step(), 1280, 720)
                     for _ in range(n)])


def _same(tout, jout):
    for k in ("ids", "emit", "num_active"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    for k in ("poses", "boxes", "scores"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=1e-2, err_msg=k)


def _same_filter(tpipe, jpipe):
    for f in ("kf_mean", "kf_cov", "velocities"):
        np.testing.assert_allclose(getattr(tpipe.state, f).numpy(),
                                   np.asarray(getattr(jpipe.state, f)),
                                   atol=1e-2, err_msg=f)


@pytest.mark.parametrize("reid", [False, True])
def test_kalman136_pipeline_matches_jax(reid):
    """Two chunks of 4 frames through process_chunk, then 4 frames through
    process_frame on a fresh pair of pipelines."""
    frames = _frames(8)
    jpipe, tpipe = _pipelines(reid)
    emitted = 0
    for chunk in (frames[:4], frames[4:]):
        tout = tpipe.process_chunk(chunk)
        _same(tout, jax.device_get(jpipe.process_chunk(chunk)))
        emitted += int(tout["emit"].sum())
    _same_filter(tpipe, jpipe)
    assert emitted >= 4 * 4 and int(tpipe.state.frame) == 8
    live = tpipe.state.active
    assert (tpipe.state.kf_cov[live] != 1.0).all()   # the filter ran
    jpipe, tpipe = _pipelines(reid)
    for fr in frames[:4]:
        _same(tpipe.process_frame(fr), jax.device_get(jpipe.process_frame(fr)))
    _same_filter(tpipe, jpipe)


def test_kalman136_stream_and_staged_chunk_keep_the_filter():
    """process_stream carries the filter as process_frame does, and
    stage_chunk + process_chunk_device as process_chunk does."""
    cfg = PipelineConfig(detector=DetectorConfig(**DET),
                         tracker=TrackerConfig(motion_model="kalman136"),
                         precision="fp32")
    params = load_params(ASSET)[0]
    frames = _frames(5, seed=3)
    a, b = (PosePipeline(cfg, params=params, device="cpu") for _ in range(2))
    streamed = list(a.process_stream(iter(frames), sync_depth=2))
    for fr, out in zip(frames, streamed):
        want = b.process_frame(fr)
        for k in ("ids", "emit", "poses", "num_active"):
            assert torch.equal(out[k], want[k]), k
    for f in ("kf_mean", "kf_cov"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    a, b = (PosePipeline(cfg, params=params, device="cpu") for _ in range(2))
    outs = a.process_chunk_device(a.stage_chunk(frames), 720, 1280)
    want = b.process_chunk(frames)
    for k in want:
        assert torch.equal(outs[k], want[k]), k
    for f in ("kf_mean", "kf_cov"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert not torch.equal(a.state.kf_mean, torch.zeros_like(a.state.kf_mean))

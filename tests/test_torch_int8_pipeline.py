"""The port's int8 (w8a8) path against the JAX package's: yolov8n-pose at
input 256 with the trained 256 checkpoint, quantised with
PARTIAL_QUANT_SKIP and calibrated by percentile (the port's
calibrate_activations on 16 synthetic-scene frames at 256; the JAX side
gets the same scales through the calibration cache), raw u8 ingest.

- The model forward (forward_heads against build_model_heads): in bf16
  within 5e-2 of each output's largest magnitude (the bar of
  tests/test_torch_models.py; 2.9e-2 measured); with float32 activations
  within 2.5e-2 of it (1.2e-2 measured), and at least 90% of the outputs
  within 1e-4 of it (94-96% measured). The float convolutions of oneDNN and
  XLA differ ~1e-6 relative, which moves a few activations across a .5
  rounding boundary of the next quantisation: one int8 step on those,
  carried through the layers after it. (int8 itself departs from the float
  model by 5-23% of the same scale.)
- PosePipeline(precision="int8", dtype=float32) per frame (process_frame)
  and per chunk (process_chunk, K = 4) against JAX's
  PosePipeline(precision="int8", dtype=float32) on the synthetic scene:
  track ids and emit equal, keypoints and boxes within 1e-2 px (the bar
  of tests/test_torch_pipeline.py; 1.2e-4 px measured).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.core.config import DetectorConfig as JDetectorConfig
from posebyte_tpu.core.config import PipelineConfig as JPipelineConfig
from posebyte_tpu.models import build_model_heads
from posebyte_tpu.models import quant as JQ
from posebyte_tpu.pipeline import PosePipeline as JPosePipeline

from posebyte_tpu_torch.core.config import DetectorConfig, PipelineConfig
from posebyte_tpu_torch.models import load_params
from posebyte_tpu_torch.models import quant as Q
from posebyte_tpu_torch.models.layers import prepare_params
from posebyte_tpu_torch.models.yolo_pose import forward_heads
from posebyte_tpu_torch.pipeline import PosePipeline
from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
    calibration_frames, render_frame
from test_torch_quant import jax_tree

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "yolov8n-pose-synthetic256.safetensors")
NAME = "yolov8n-pose"
DET = dict(input_size=256, num_anchors=1344)
W, H = 1280, 720
KP_TOL = 1e-2


@pytest.fixture(scope="module")
def qparams(tmp_path_factory):
    """(port's calibrated int8 params, JAX's tree with the same scales)."""
    pq = Q.calibrate_activations(
        Q.quantize_params(load_params(ASSET)[0]), NAME,
        calibration_frames(16, 256, seed=1), device="cpu")
    cache = str(tmp_path_factory.mktemp("int8") / "cache.json")
    assert Q.save_calibration_cache(pq, cache) == 59
    jq = JQ.quantize_params(jax_tree(load_params(ASSET)[0]))
    assert JQ.load_calibration_cache(jq, cache) == 59
    return pq, jq


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_int8_forward_matches_jax(qparams, precision):
    pq, jq = qparams
    jdtype = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[precision]
    tdtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[precision]
    tol = {"fp32": 2.5e-2, "bf16": 5e-2}[precision]
    x = calibration_frames(2, 256, seed=9)
    heads_fn, _ = build_model_heads(NAME, jdtype)
    want = jax.jit(heads_fn)(jq, jnp.asarray(x))
    params = prepare_params(pq, tdtype, "cpu")
    assert sum(k.endswith(".wq") for k in params) == 59
    with torch.inference_mode():
        got = forward_heads(params, torch.from_numpy(x).to(tdtype))
    for g, w, c in zip(got, want, (64, 1, 51)):
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == (2, 1344, c) and g.dtype == tdtype
        scale = float(np.abs(w).max())
        err = np.abs(g.float().numpy() - w)
        assert float(err.max()) <= tol * scale, (float(err.max()), scale)
        if precision == "fp32":
            assert (err <= 1e-4 * scale).mean() >= 0.9


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_int8_forward_gives_kernel_4_its_layouts(qparams, precision):
    """Every one of the 59 w8a8 convolutions of the forward gets its float
    activation in a layout Kernel 4's float mode reads without a copy (NHWC
    memory, channel stride 1; c2f's channel slices among them), so that on
    the card each is one launch and nothing else."""
    from posebyte_tpu_torch.models import layers as L
    from posebyte_tpu_torch.ops.conv_int8 import pixel_stride
    tdtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[precision]
    params = prepare_params(qparams[0], tdtype, "cpu")
    seen, conv = [], L.conv_w8a8

    def record(x, *args, **kw):
        seen.append((x.dtype, x.shape[1], pixel_stride(x)))
        return conv(x, *args, **kw)

    L.conv_w8a8 = record
    try:
        with torch.inference_mode():
            forward_heads(params, torch.from_numpy(
                calibration_frames(1, 256, seed=3)).to(tdtype))
    finally:
        L.conv_w8a8 = conv
    assert len(seen) == 59
    assert all(dt == tdtype and ps is not None for dt, _, ps in seen), seen
    assert any(ps > c for _, c, ps in seen)      # channel slices go in


def _frames(n, seed=11, persons=4):
    scene = SyntheticScene(persons, W, H, seed=seed)
    return np.stack([render_frame(scene.step(), W, H) for _ in range(n)])


def _pipelines(qparams):
    pq, jq = qparams
    jpipe = JPosePipeline(JPipelineConfig(detector=JDetectorConfig(**DET),
                                          precision="int8"),
                          params=jq, dtype=jnp.float32)
    tpipe = PosePipeline(PipelineConfig(detector=DetectorConfig(**DET),
                                        precision="int8"),
                         params=pq, device="cpu", dtype=torch.float32)
    return jpipe, tpipe


def test_int8_frame_pipeline_matches_jax(qparams):
    jpipe, tpipe = _pipelines(qparams)
    assert tpipe.dtype == torch.float32
    n_tracks = []
    for fr in _frames(5):
        jt = jpipe.fetch_outputs(jpipe.process_frame(fr), W, H)
        tt = tpipe.fetch_outputs(tpipe.process_frame(fr), W, H)
        assert [t.track_id for t in tt] == [t.track_id for t in jt]
        for a, b in zip(tt, jt):
            np.testing.assert_allclose(a.keypoints, b.keypoints, atol=KP_TOL)
            np.testing.assert_allclose(a.bbox, b.bbox, atol=KP_TOL)
        n_tracks.append(len(tt))
    assert n_tracks[-1] >= 3                 # the people are tracked


def test_int8_chunk_pipeline_matches_jax(qparams):
    jpipe, tpipe = _pipelines(qparams)
    frames = _frames(8, seed=4)
    emitted = 0
    for chunk in (frames[:4], frames[4:]):
        jout = jax.device_get(jpipe.process_chunk(chunk))
        tout = tpipe.process_chunk(chunk)
        for k in ("ids", "emit", "num_active"):
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k]), err_msg=k)
        for k in ("poses", "boxes", "scores"):
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       atol=KP_TOL, err_msg=k)
        emitted += int(tout["emit"].sum())
    assert emitted >= 4 * 4


def test_int8_runs_bf16_activations_by_default(qparams):
    """precision="int8" without dtype: bf16 activations between the w8a8
    convolutions, as the JAX runner's default; the tracks agree with the
    float32-activation run's within a few pixels."""
    pq, _ = qparams
    cfg = PipelineConfig(detector=DetectorConfig(**DET), precision="int8")
    pipe = PosePipeline(cfg, params=pq, device="cpu")
    ref = PosePipeline(cfg, params=pq, device="cpu", dtype=torch.float32)
    assert pipe.dtype == torch.bfloat16
    assert pipe.params["b6.m.0.cv1.wq"].dtype == torch.int8
    assert pipe.params["b0.w"].dtype == torch.bfloat16
    for fr in _frames(3, seed=2):
        got = pipe.fetch_outputs(pipe.process_frame(fr), W, H)
        want = ref.fetch_outputs(ref.process_frame(fr), W, H)
        assert [t.track_id for t in got] == [t.track_id for t in want]
        for a, b in zip(got, want):
            assert np.abs(a.keypoints[:, :2] - b.keypoints[:, :2]).max() < 8

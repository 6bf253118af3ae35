"""The port's legacy NMS (ops/legacy_nms.py), LegacyTrackerConfig and
YoloPoseEngine (models/engine.py) against the JAX package on the CPU, with
the cases of tests/test_engine_legacy_nms.py:

- legacy_pose_nms: the kept set equal to the direct NumPy port of
  NMSCuda::apply there, and every output equal to JAX's legacy_pose_nms bit
  for bit (clustered poses, ties in score, a score threshold, max_keep
  below the kept count); legacy_oks_pair_matrix symmetric with a unit
  diagonal and within 1e-6 of JAX's (exp rounds differently in XLA and
  PyTorch by an ulp);
- the engine: save_engine / load_engine, detect, detect_batch,
  detect_device_native, detect_from_device and get_last_inference_time on
  yolov8n at input 128 against the JAX engine on the same weights (the
  port's seed-0 init_params carried to the JAX tree): validity equal,
  scores within 1e-5 relative, keypoints within 1e-3 px (about 60 float32
  conv layers, tests/test_torch_models.py); assigning engine.params takes
  effect on the next call, quantised params included; no card and no
  device="cpu" raises.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.core import config as JC
from posebyte_tpu.core.structs import Detections as JDetections
from posebyte_tpu.ops import legacy_nms as JL

from posebyte_tpu_torch.core import config as TC
from posebyte_tpu_torch.core.structs import Detections
from posebyte_tpu_torch.models.engine import YoloPoseEngine
from posebyte_tpu_torch.ops.legacy_nms import (legacy_oks_pair_matrix,
                                               legacy_pose_nms)

from test_engine_legacy_nms import _np_legacy_nms
from test_torch_quant import jax_tree

torch.set_num_threads(4)

FIELDS = ("poses", "boxes", "scores", "valid")


def _cluster(random_pose_factory, n, seed, tie=False):
    rng = np.random.default_rng(seed)
    poses = np.zeros((n, 17, 3), np.float32)
    boxes = np.zeros((n, 4), np.float32)
    for i in range(n):
        p = random_pose_factory()
        if i % 3:
            p[:, 0] += rng.normal(0, 8)
            p[:, 1] += rng.normal(0, 8)
        poses[i] = p
        boxes[i] = [p[:, 0].min() - 5, p[:, 1].min() - 5,
                    p[:, 0].max() + 5, p[:, 1].max() + 5]
    scores = rng.uniform(0.3, 1.0, n).astype(np.float32)
    if tie:
        scores = np.round(scores * 4) / 4
    return poses, boxes, scores


@pytest.mark.parametrize("case", ["plain", "ties", "threshold", "max_keep"])
def test_legacy_nms_matches_numpy_port_and_jax(random_pose_factory, case):
    n = 24
    poses, boxes, scores = _cluster(random_pose_factory, n,
                                    {"plain": 7, "ties": 8, "threshold": 9,
                                     "max_keep": 10}[case],
                                    tie=case == "ties")
    valid = np.ones((n,), bool)
    valid[5] = case != "plain"           # one padded slot in three cases
    thr = 0.6 if case == "threshold" else 0.0
    max_keep = 3 if case == "max_keep" else 24
    got = legacy_pose_nms(Detections(*map(torch.from_numpy,
                                          (poses, boxes, scores, valid))),
                          score_threshold=thr, max_keep=max_keep)
    want = JL.legacy_pose_nms(JDetections(*map(jnp.asarray, (poses, boxes,
                                                             scores, valid))),
                              score_threshold=thr, max_keep=max_keep)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    keep = _np_legacy_nms(poses[valid], boxes[valid], scores[valid], thr)
    want_scores = np.sort(scores[valid][keep])[::-1][:max_keep]
    np.testing.assert_array_equal(got.scores[got.valid].numpy(), want_scores)


def test_legacy_oks_matrix(random_pose_factory):
    poses = np.stack([random_pose_factory() for _ in range(6)])
    poses[2, :15, 2] = 0.1                       # too few visible keypoints
    m = legacy_oks_pair_matrix(torch.from_numpy(poses)).numpy()
    np.testing.assert_allclose(m, m.T, rtol=1e-5)
    np.testing.assert_allclose(np.diag(m)[[0, 1, 3, 4, 5]], 1.0, atol=1e-6)
    assert m[2].max() == 0.0
    np.testing.assert_allclose(
        m, np.asarray(JL.legacy_oks_pair_matrix(jnp.asarray(poses))),
        rtol=1e-6, atol=1e-7)


def test_legacy_tracker_config_matches_jax():
    ours = [(f.name, f.default) for f in
            dataclasses.fields(TC.LegacyTrackerConfig)]
    assert ours == [(f.name, f.default) for f in
                    dataclasses.fields(JC.LegacyTrackerConfig)]
    from posebyte_tpu_torch.core import LegacyTrackerConfig
    assert LegacyTrackerConfig is TC.LegacyTrackerConfig


def _lists_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a["keypoints"].shape == (17, 3)
        np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5)
        np.testing.assert_allclose(a["bbox"], np.asarray(b["bbox"]),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(a["keypoints"], np.asarray(b["keypoints"]),
                                   rtol=1e-5, atol=1e-3)


def test_engine_roundtrip_and_paths_match_jax(tmp_path):
    from posebyte_tpu.models.engine import YoloPoseEngine as JEngine
    from posebyte_tpu_torch.models import init_params
    params = init_params(0, "yolov8n-pose")
    kw = dict(input_size=128, max_candidates=32, max_detections=8,
              conf_threshold=0.05)
    eng = YoloPoseEngine("yolov8n-pose", TC.DetectorConfig(**kw), params,
                         precision="fp32", device="cpu")
    jeng = JEngine("yolov8n-pose", JC.DetectorConfig(**kw),
                   params=jax_tree(params), precision="fp32")
    assert not eng.config.raw_preproc

    path = str(tmp_path / "eng.safetensors")
    eng.save_engine(path)
    eng2 = YoloPoseEngine.load_engine(path, precision="fp32",
                                      config=eng.config, device="cpu")
    assert eng2.model_name == "yolov8n-pose"
    for k, v in params.items():
        np.testing.assert_array_equal(eng2.params[k], v)

    rng = np.random.default_rng(0)
    frame = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)
    frame2 = rng.integers(0, 255, (96, 128, 3), dtype=np.uint8)

    dets = eng.detect(frame)
    assert dets and eng.get_last_inference_time() > 0
    _lists_close(dets, jeng.detect(frame))
    batch = eng.detect_batch(np.stack([frame, frame2]))
    assert len(batch) == 2
    for a, b in zip(batch, jeng.detect_batch(np.stack([frame, frame2]))):
        _lists_close(a, b)

    flat = torch.from_numpy(frame.reshape(-1))
    det = eng.detect_device_native(flat, 96, 128)
    assert det.poses.shape == (8, 17, 3)
    jdet = jeng.detect_device_native(jnp.asarray(frame.reshape(-1)), 96, 128)
    np.testing.assert_array_equal(det.valid.numpy(), np.asarray(jdet.valid))
    assert det.valid.any()
    np.testing.assert_allclose(det.scores.numpy(), np.asarray(jdet.scores),
                               rtol=1e-5)
    np.testing.assert_allclose(det.poses.numpy(), np.asarray(jdet.poses),
                               rtol=1e-5, atol=1e-3)
    _lists_close(eng.detect_from_device(flat, 96, 128),
                 jeng.detect_from_device(jnp.asarray(frame.reshape(-1)),
                                         96, 128))


def test_engine_params_mutation_takes_effect():
    from posebyte_tpu_torch.models.quant import quantize_params
    cfg = TC.DetectorConfig(input_size=128, max_candidates=16,
                            max_detections=4)
    eng = YoloPoseEngine("yolov8n-pose", cfg, precision="fp32",
                         device="cpu")
    flat = torch.from_numpy(np.random.default_rng(1).integers(
        0, 255, (96, 128, 3), dtype=np.uint8).reshape(-1))
    s1 = eng.detect_device_native(flat, 96, 128).scores
    eng.params = {k: v * 1.5 for k, v in eng.params.items()}
    s2 = eng.detect_device_native(flat, 96, 128).scores
    assert not torch.allclose(s1, s2)
    eng.params = quantize_params(eng.params)
    assert any(k.endswith(".scale") for k in eng.params)
    det3 = eng.detect_device_native(flat, 96, 128)
    assert det3.poses.shape == (4, 17, 3)


def test_engine_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YoloPoseEngine()
    with pytest.raises(ValueError, match="unknown model"):
        YoloPoseEngine("nope", device="cpu")

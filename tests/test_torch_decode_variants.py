"""The port's decode variants against the JAX package on the CPU, on the
same numpy inputs, with JAX's own cases (tests/test_topk.py,
tests/test_decode_fusion.py):

- ops.topk: topk_masked_bisect equal to lax.top_k bit for bit (values and
  indices: the (A, k) pairs x fill fractions, heavy ties, all fillers,
  zeros, subnormals and -0.0), batched over a leading axis as JAX vmaps
  it; "approx" equal to lax.approx_max_k's CPU result (exact off the
  TPU); onehot_select equal to JAX's one-hot matmul on finite payloads.
- ops.decode: decode_topk_levels equal to the port's decode_topk on the
  concatenated levels bit for bit (modes normal, ties, sparse and none x
  both gather_impls x sort and bisect, and bf16 heads); against JAX's
  decode_topk_levels validity equal, scores within 2 float32 ulps (XLA's
  logistic and PyTorch's sigmoid round differently by up to one), decoded
  coordinates within 2e-6 relative plus 2e-4 px (the DFL expectation's
  summation order, tests/test_torch_preprocess_decode.py); decode_yolo_
  output and its batch form equal to JAX's on the same dense tensor.
- pipeline: decode_fusion="tail" against "post" per frame and per chunk on
  yolov8n at input 64 (outputs equal bit for bit) and the tail path's ids
  equal to the JAX package's; topk_impl="bisect" with gather_impl="onehot"
  equal to the default; detect_fn and detect_fn_levels against JAX's
  detect_fn.

The pipeline cases run the port's seed-3 weights, carried to the JAX tree
as test_torch_quant.jax_tree fills it.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.ops import decode as JD
from posebyte_tpu.ops import topk as JK

from posebyte_tpu_torch.ops import decode as D
from posebyte_tpu_torch.ops import topk as K

from test_torch_quant import jax_tree

torch.set_num_threads(2)

S = 64                     # pyramid 8x8 / 4x4 / 2x2 -> A = 84
LEVEL_AS = [(S // 8) ** 2, (S // 16) ** 2, (S // 32) ** 2]
FIELDS = ("poses", "boxes", "scores", "valid")


def _ranked(rng, a, fill_frac, quantize=None):
    """The decode domain: sigmoid-like values and -1.0 fillers."""
    conf = rng.uniform(0.0, 1.0, a).astype(np.float32)
    if quantize:
        conf = np.round(conf * quantize) / quantize
    mask = rng.uniform(0, 1, a) < fill_frac
    return np.where(mask, -1.0, conf).astype(np.float32)


def _assert_topk_equal(r: np.ndarray, k: int, impl: str = "bisect"):
    ev, ei = jax.lax.top_k(jnp.asarray(r), k)
    bv, bi = K.topk_confidence(torch.from_numpy(r), k, impl)
    np.testing.assert_array_equal(bv.numpy(), np.asarray(ev))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ei))


@pytest.mark.parametrize("a,k", [(8400, 256), (8400, 64), (1000, 256),
                                 (257, 256), (8400, 1)])
@pytest.mark.parametrize("fill_frac", [0.0, 0.5, 0.97, 1.0])
def test_bisect_matches_lax_topk(a, k, fill_frac):
    rng = np.random.default_rng(a * 1000 + k + int(fill_frac * 100))
    _assert_topk_equal(_ranked(rng, a, fill_frac), k)


@pytest.mark.parametrize("quantize", [4, 16, 2])
def test_bisect_tie_breaks(quantize):
    rng = np.random.default_rng(quantize)
    _assert_topk_equal(_ranked(rng, 4096, 0.3, quantize=quantize), 256)


def test_bisect_all_fillers_and_subnormal_edge():
    _assert_topk_equal(np.full((512,), -1.0, np.float32), 64)
    _assert_topk_equal(np.asarray([0.0, 2e-38, -1.0, 1.5e-38, 0.0, -1.0,
                                   1e-39, 5e-39], np.float32), 4)
    _assert_topk_equal(np.asarray([0.5, -0.0, -1.0, 0.25, 0.0], np.float32),
                       4)


def test_bisect_batched_like_vmap():
    """A leading axis of frames: each row equal to lax.top_k's, and the
    JAX package's own bisect under vmap."""
    rng = np.random.default_rng(5)
    r = np.stack([_ranked(rng, 1344, f, quantize=q)
                  for f, q in ((0.0, None), (0.5, 8), (0.99, None),
                               (1.0, None))])
    bv, bi = K.topk_masked_bisect(torch.from_numpy(r), 128)
    jv, ji = jax.vmap(lambda x: JK.topk_masked_bisect(x, 128))(
        jnp.asarray(r))
    np.testing.assert_array_equal(bv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("fill_frac", [0.0, 0.9])
def test_approx_equals_jax_cpu(fill_frac):
    """lax.approx_max_k off the TPU is the exact top-k; the port's "approx"
    equals JAX's CPU result."""
    r = _ranked(np.random.default_rng(9), 2000, fill_frac, quantize=32)
    jv, ji = JK.topk_confidence(jnp.asarray(r), 100, "approx")
    v, i = K.topk_confidence(torch.from_numpy(r), 100, "approx")
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_topk_confidence_dispatch():
    r = torch.from_numpy(_ranked(np.random.default_rng(0), 512, 0.5))
    for impl in ("sort", "bisect", "approx"):
        v, i = K.topk_confidence(r, 32, impl)
        assert v.shape == (32,) and i.shape == (32,)
    with pytest.raises(ValueError):
        K.topk_confidence(r, 32, "nope")


def test_onehot_select_matches_jax():
    rng = np.random.default_rng(3)
    payload = rng.normal(0, 1, (50, 7)).astype(np.float32)
    payload[::9] = 1e-40                      # subnormals kept on the CPU
    idx = rng.integers(0, 50, 12)
    onehot = idx[:, None] == np.arange(50)
    onehot[4] = False                         # a row with no selection
    want = np.asarray(JK.onehot_select(jnp.asarray(onehot),
                                       jnp.asarray(payload)))
    got = K.onehot_select(torch.from_numpy(onehot), torch.from_numpy(payload))
    np.testing.assert_array_equal(got.numpy(), want)


def _random_levels(rng, mode="normal"):
    levels = []
    for A in LEVEL_AS:
        b = rng.normal(0, 1, (A, 64)).astype(np.float32)
        c = rng.normal(0, 2, (A, 1)).astype(np.float32)
        k = rng.normal(0, 1, (A, 51)).astype(np.float32)
        if mode == "ties":
            c[:] = np.float32(0.3)
        elif mode == "sparse":
            c[:] = -10.0
            c[rng.integers(0, A, 3), 0] = 2.0
        elif mode == "none":
            c[:] = -10.0
        levels.append((b, c, k))
    return levels


def _torch_levels(levels, dtype=torch.float32):
    return tuple(tuple(torch.from_numpy(a).to(dtype) for a in lv)
                 for lv in levels)


def _assert_same(a, b, what):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), (f, what)


def _assert_close_to_jax(t, j):
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(t.scores.numpy(), np.asarray(j.scores),
                               rtol=2.5e-7, atol=0)
    for f in ("poses", "boxes"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)),
                                   rtol=2e-6, atol=2e-4)


@pytest.mark.parametrize("mode", ["normal", "ties", "sparse", "none"])
@pytest.mark.parametrize("gather_impl", ["index", "onehot"])
@pytest.mark.parametrize("topk_impl", ["sort", "bisect"])
def test_levels_bit_identical_to_concat(mode, gather_impl, topk_impl):
    rng = np.random.default_rng(
        zlib.crc32(f"{mode}/{gather_impl}/{topk_impl}".encode()))
    levels = _random_levels(rng, mode)
    cat = [torch.from_numpy(np.concatenate([lv[j] for lv in levels]))
           for j in range(3)]
    kw = dict(topk_impl=topk_impl, gather_impl=gather_impl)
    post = D.decode_topk(*cat, 0.25, 32, S, **kw)
    tail = D.decode_topk_levels(_torch_levels(levels), 0.25, 32, S, **kw)
    _assert_same(post, tail, (mode, gather_impl, topk_impl))
    _assert_close_to_jax(tail, JD.decode_topk_levels(
        tuple(tuple(jnp.asarray(a) for a in lv) for lv in levels), 0.25, 32,
        S, **kw))


def test_levels_bf16_heads_bit_identical():
    levels = _torch_levels(_random_levels(np.random.default_rng(11)),
                           torch.bfloat16)
    cat = [torch.cat([lv[j] for lv in levels]) for j in range(3)]
    for gi in ("index", "onehot"):
        _assert_same(D.decode_topk(*cat, 0.25, 32, S, gather_impl=gi),
                     D.decode_topk_levels(levels, 0.25, 32, S,
                                          gather_impl=gi), gi)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_gather_impls_match_jax(dtype):
    """Both gather_impls against JAX's, subnormal keypoint logits included
    (the CPU's matmul keeps them, as the port's gather does)."""
    rng = np.random.default_rng(11)
    A = 1344
    box = rng.normal(0, 1, (A, 64)).astype(np.float32)
    cls = rng.normal(-2, 2, (A, 1)).astype(np.float32)
    kpt = rng.normal(0, 1, (A, 51)).astype(np.float32)
    kpt[::97] = 1e-40
    tt = [torch.from_numpy(a).to(getattr(torch, dtype))
          for a in (box, cls, kpt)]
    jt = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
          for t in tt]
    for gi in ("index", "onehot"):
        got = D.decode_topk(*tt, 0.25, 256, 256, gather_impl=gi)
        _assert_close_to_jax(got, JD.decode_topk(*jt, 0.25, 256, 256,
                                                 gather_impl=gi))
    with pytest.raises(ValueError):
        D.decode_topk(*tt, 0.25, 16, 256, gather_impl="bogus")


def test_decode_variants_batched_chunk():
    """The chunk's leading K axis: every exact combination equal."""
    rng = np.random.default_rng(3)
    A, Kf = 1344, 4
    box, cls, kpt = (torch.from_numpy(rng.normal(m, s, (Kf, A, c)).astype(
        np.float32)).to(torch.bfloat16) for m, s, c in
        ((0, 1, 64), (-2, 2, 1), (0, 1, 51)))
    ref = D.decode_topk(box, cls, kpt, 0.25, 256, 256)
    for ti in ("sort", "bisect", "approx"):
        for gi in ("index", "onehot"):
            _assert_same(ref, D.decode_topk(box, cls, kpt, 0.25, 256, 256,
                                            topk_impl=ti, gather_impl=gi),
                         (ti, gi))


def _dense(seed, B=2, A=84):
    """A dense [B, 56, A] tensor in forward_raw's value ranges."""
    rng = np.random.default_rng(seed)
    raw = rng.uniform(0, 64, (B, 56, A)).astype(np.float32)
    raw[:, 2:4] = rng.uniform(4, 30, (B, 2, A))
    raw[:, 4] = np.round(rng.uniform(0, 1, (B, A)) * 16) / 16   # ties
    raw[:, 7::3] = rng.uniform(0, 1, (B, 17, A))
    return raw


def test_decode_yolo_output_matches_jax():
    raw = _dense(0)
    for b in range(raw.shape[0]):
        j = JD.decode_yolo_output(jnp.asarray(raw[b]), 0.25, 32)
        t = D.decode_yolo_output(torch.from_numpy(raw[b]), 0.25, 32)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
    jb = JD.decode_yolo_output_batch(jnp.asarray(raw), 0.25, 32)
    tb = D.decode_yolo_output_batch(torch.from_numpy(raw), 0.25, 32)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))


def _configs(fusion, **det):
    from posebyte_tpu.core import config as JC
    from posebyte_tpu_torch.core import config as TC
    kw = dict(input_size=64, num_anchors=84, conf_threshold=0.01,
              max_detections=8, decode_fusion=fusion, **det)
    return tuple(mod.PipelineConfig(
        detector=mod.DetectorConfig(**kw),
        tracker=mod.TrackerConfig(max_tracks=8, max_detections=8),
        precision="fp32") for mod in (JC, TC))


@pytest.fixture(scope="module")
def seed3_params():
    """yolov8n's random weights from seed 3 (the port's init_params), in
    the port's layout and as the JAX tree (test_torch_quant.jax_tree)."""
    from posebyte_tpu_torch.models import init_params
    params = init_params(3, "yolov8n-pose")
    return params, jax_tree(params)


def test_pipeline_chunk_and_frame_tail_matches_post(seed3_params):
    """decode_fusion "tail" against "post" on the real yolov8n graph
    (random weights, input 64): every output equal, per chunk and per
    frame; the tail chunk's ids equal to the JAX package's tail run."""
    from posebyte_tpu.pipeline import PosePipeline as JPipe
    from posebyte_tpu_torch.pipeline import PosePipeline
    params, jparams = seed3_params
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (3, 96, 128, 3), dtype=np.uint8)
    chunk, frame = {}, {}
    for fusion in ("post", "tail"):
        jcfg, tcfg = _configs(fusion)
        pipe = PosePipeline(tcfg, params, device="cpu")
        chunk[fusion] = pipe.process_chunk(frames)
        pipe.reset()
        frame[fusion] = pipe.process_frame(frames[2])
    for outs in (chunk, frame):
        for key in ("ids", "scores", "poses", "boxes", "emit", "num_active"):
            assert torch.equal(outs["post"][key], outs["tail"][key]), key
    jcfg, _ = _configs("tail")
    j_ids = np.asarray(JPipe(jcfg, jparams).process_chunk(frames)["ids"])
    np.testing.assert_array_equal(chunk["tail"]["ids"].numpy(), j_ids)
    assert (j_ids >= 0).any()


def test_pipeline_chunk_identical_under_decode_variants(seed3_params):
    from posebyte_tpu_torch.pipeline import PosePipeline
    _, base = _configs("post")
    variant = dataclasses.replace(base, detector=dataclasses.replace(
        base.detector, topk_impl="bisect", gather_impl="onehot"))
    frames = np.random.default_rng(1).integers(0, 255, (4, 120, 160, 3),
                                               dtype=np.uint8)
    params, _ = seed3_params
    oa = PosePipeline(base, params, device="cpu").process_chunk(frames)
    ob = PosePipeline(variant, params, device="cpu").process_chunk(frames)
    for key in oa:
        assert torch.equal(oa[key], ob[key]), key


def test_detect_fn_and_levels_match_jax(seed3_params):
    """pipeline.detect_fn and detect_fn_levels on one normalised image:
    equal to each other bit for bit, and to JAX's detect_fn (validity and
    scores equal, coordinates within 1e-3 px after ~60 float32 conv
    layers)."""
    from posebyte_tpu.core.config import DetectorConfig as JDC
    from posebyte_tpu.models.yolo_pose import build_model_heads as jheads
    from posebyte_tpu.pipeline import detect_fn as j_detect
    from posebyte_tpu_torch.core import DetectorConfig
    from posebyte_tpu_torch.models.layers import prepare_params
    from posebyte_tpu_torch.models.yolo_pose import (build_model_head_maps,
                                                     build_model_heads)
    from posebyte_tpu_torch.pipeline import detect_fn
    from posebyte_tpu_torch.pipeline.runner import detect_fn_levels
    kw = dict(input_size=64, conf_threshold=0.01, max_candidates=32,
              max_detections=8)
    img = np.random.default_rng(2).uniform(0, 1, (64, 64, 3)) \
        .astype(np.float32)
    params = prepare_params(seed3_params[0], torch.float32, "cpu")
    heads, _ = build_model_heads("yolov8n-pose")
    cfg = DetectorConfig(**kw)
    with torch.inference_mode():
        a = detect_fn(params, torch.from_numpy(img), cfg, heads)
        b = detect_fn_levels(params, torch.from_numpy(img), cfg,
                             build_model_head_maps("yolov8n-pose"))
    _assert_same(a, b, "detect_fn_levels")
    jh, _ = jheads("yolov8n-pose")
    j = j_detect(seed3_params[1], jnp.asarray(img), JDC(**kw), jh)
    np.testing.assert_array_equal(a.valid.numpy(), np.asarray(j.valid))
    assert a.valid.any()
    np.testing.assert_allclose(a.scores.numpy(), np.asarray(j.scores),
                               rtol=1e-5)
    np.testing.assert_allclose(a.poses.numpy(), np.asarray(j.poses),
                               rtol=1e-5, atol=1e-3)

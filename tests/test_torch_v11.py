"""YOLO11-pose in the port (models/layers.py: dwconv_block, c3, c3k2,
attention, psablock, c2psa; models/yolo_pose.py: the v11 backbone, neck and
head; the depthwise w8a8 route of ops/conv_int8.py; PosePipeline with
model_name="yolo11n-pose") against the JAX package on the CPU.

Inputs and block weights are made from numpy seeds: the blocks' trees have
the structure of the JAX package's *_init functions (by jax.eval_shape)
with He-normal weights and normal biases. yolo11n-pose runs the trained
640 checkpoint (assets/yolo11n-pose-synthetic640.safetensors), yolo11m-pose
(C3k in every C3k2, 4 attention heads) such seeded weights in init_params'
tree.

Tolerances:
- blocks and forward_heads at fp32 within 2e-5 of each output's largest
  magnitude (the v8 model test's bar: XLA's and oneDNN's convolutions and
  matmuls sum in different orders), at bf16 within 5e-2 of it (bf16 keeps
  8 mantissa bits and the frameworks round at different points);
- PosePipeline fp32 per frame and per chunk: track ids and emit equal,
  keypoints and boxes within 1e-2 px (tests/test_torch_pipeline.py's bar);
- int8 (float32 activations, the JAX side given the port's scales through
  the calibration cache): the forward within 2.5e-2 of each output's
  largest magnitude with 90% of it within 1e-4 (the v8 int8 test's bars:
  an ulp of a float conv moves an activation across a rounding boundary
  of the next quantisation now and then), the chunk path's ids equal with
  99% of its values within 1e-2 px and all within 8 px (such a flip moves
  a few by a fraction of a pixel), the per-frame path's ids equal with
  keypoints within 8 px, median 0.5 (chip_smoke's int8 card/CPU bars:
  there the flip comes at b5 and runs through every later layer), every
  conv's float input within 1e-6 of JAX's up to the first flip; the
  depthwise route bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from posebyte_tpu.core.config import DetectorConfig as JDetectorConfig
from posebyte_tpu.core.config import PipelineConfig as JPipelineConfig
from posebyte_tpu.models import build_model_heads
from posebyte_tpu.models import layers as JL
from posebyte_tpu.models import quant as JQ
from posebyte_tpu.models.yolo_pose import init_params
from posebyte_tpu.pipeline import PosePipeline as JPosePipeline

from posebyte_tpu_torch.core.config import DetectorConfig, PipelineConfig
from posebyte_tpu_torch.models import layers as L
from posebyte_tpu_torch.models import load_params
from posebyte_tpu_torch.models import quant as Q
from posebyte_tpu_torch.models import weights as W
from posebyte_tpu_torch.models.yolo_pose import MODEL_CONFIGS, forward_heads
from posebyte_tpu_torch.ops import conv_int8 as CI
from posebyte_tpu_torch.pipeline import PosePipeline
from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
    calibration_frames, render_frame
from test_torch_quant import jax_tree

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "yolo11n-pose-synthetic640.safetensors")
NAME = "yolo11n-pose"
TOL = {"fp32": 2e-5, "bf16": 5e-2}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
# input 192 on 320x240 frames: the people are as large in the letterbox as
# at 640 on the checkpoint's training frames (tests/test_pipeline.py's
# v11 case runs 192 on 240x320)
DET = dict(input_size=192, num_anchors=756)
FW, FH = 320, 240
KP_TOL = 1e-2


def seeded_tree(init_fn, seed):
    """init_fn's parameter tree (structure by eval_shape, so that JAX's
    random initialisation is skipped) with He-normal conv weights (HWIO)
    and N(0, 0.1) biases from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))

    def leaf(s):
        if len(s.shape) == 4:
            std = np.sqrt(2.0 / np.prod(s.shape[:3]))
            return jnp.asarray(rng.normal(0, std, s.shape).astype(np.float32))
        return jnp.asarray(rng.normal(0, 0.1, s.shape).astype(np.float32))

    return jax.tree.map(leaf, shapes)


def close(got, want, tol, what=""):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# name -> (init_fn, JAX forward, port forward, input channels)
BLOCKS = {
    "dwconv_block": (lambda k: JL.dwconv_init(k, 24, 3), JL.dwconv_block,
                     lambda p, x: L.dwconv_block(p, "blk", x), 24),
    "c3": (lambda k: JL.c3_init(k, 16, 24, n=2, bk=(3, 3)), JL.c3,
           lambda p, x: L.c3(p, "blk", x), 16),
    "c3k2_bottleneck": (lambda k: JL.c3k2_init(k, 16, 32, n=2, c3k=False),
                        JL.c3k2, lambda p, x: L.c3k2(p, "blk", x), 16),
    "c3k2_c3k": (lambda k: JL.c3k2_init(k, 24, 32, n=1, c3k=True), JL.c3k2,
                 lambda p, x: L.c3k2(p, "blk", x), 24),
    "attention": (lambda k: JL._attention_init(k, 128, 2), JL._attention,
                  lambda p, x: L.attention(p, "blk", x, 2), 128),
    "psablock": (lambda k: JL._psablock_init(k, 64, 1), JL._psablock,
                 lambda p, x: L.psablock(p, "blk", x, 1), 64),
    "c2psa": (lambda k: JL.c2psa_init(k, 256, 1), JL.c2psa,
              lambda p, x: L.c2psa(p, "blk", x), 256),
}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_jax(block, precision):
    init_fn, jfn, tfn, c = BLOCKS[block]
    tree = seeded_tree(init_fn, seed=len(block))
    x = np.random.default_rng(3).normal(0, 1, (2, 8, 6, c)) \
        .astype(np.float32)
    want = jax.jit(jfn)(tree, jnp.asarray(x, JDT[precision]))
    flat = W.params_from_jax({"blk": jax.tree.map(np.asarray, tree)})
    p = L.prepare_params(flat, TDT[precision], "cpu")
    xt = torch.from_numpy(x).to(TDT[precision]).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = tfn(p, xt)
    assert got.dtype == TDT[precision]
    close(got.permute(0, 2, 3, 1), want, TOL[precision], block)


def test_attention_takes_its_head_count_from_the_caller():
    """qkv's width is 2 C for any head count: the same weights give other
    outputs with another count, so the count cannot come from them."""
    tree = seeded_tree(lambda k: JL._attention_init(k, 128, 2), seed=1)
    flat = W.params_from_jax({"blk": jax.tree.map(np.asarray, tree)})
    p = L.prepare_params(flat, torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, (1, 128, 4, 4)).astype(np.float32))
    with torch.inference_mode():
        two, one = (L.attention(p, "blk", x, nh) for nh in (2, 1))
    assert not torch.allclose(two, one)


@pytest.fixture(scope="module")
def asset():
    flat, name = load_params(ASSET)
    assert name == NAME
    return flat, jax_tree(flat, NAME)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_heads_yolo11n_matches_jax(asset, precision):
    flat, jtree = asset
    x = np.random.default_rng(0).uniform(0, 1, (1, 256, 256, 3)) \
        .astype(np.float32)
    heads_fn, _ = build_model_heads(NAME, JDT[precision])
    want = jax.jit(heads_fn)(jtree, jnp.asarray(x))
    p = L.prepare_params(flat, TDT[precision], "cpu")
    with torch.inference_mode():
        got = forward_heads(p, torch.from_numpy(x).to(TDT[precision]),
                            "v11")
    for g, w, c in zip(got, want, (64, 1, 51)):
        assert g.shape == (1, 1344, c) and g.dtype == TDT[precision]
        close(g, w, TOL[precision])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_heads_yolo11m_matches_jax(precision):
    name = "yolo11m-pose"
    cfg = MODEL_CONFIGS[name]
    assert cfg.c3k_everywhere and cfg.ch(1024) // 2 // 64 == 4
    tree = seeded_tree(lambda k: init_params(k, name), seed=11)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)) \
        .astype(np.float32)
    heads_fn, _ = build_model_heads(name, JDT[precision])
    want = jax.jit(heads_fn)(tree, jnp.asarray(x))
    flat = W.params_from_jax(jax.tree.map(np.asarray, tree))
    assert "b2.m.0.1.cv3.w" in flat and "b10.m.0.attn.qkv.w" in flat
    p = L.prepare_params(flat, TDT[precision], "cpu")
    with torch.inference_mode():
        got = forward_heads(p, torch.from_numpy(x).to(TDT[precision]),
                            cfg.family)
    for g, w in zip(got, want):
        close(g, w, TOL[precision])


def test_forward_heads_rejects_an_unknown_family(asset):
    p = L.prepare_params(asset[0], torch.float32, "cpu")
    with pytest.raises(ValueError, match="family"):
        forward_heads(p, torch.zeros(1, 64, 64, 3), "v5")


def _frames(n, seed=11, persons=4):
    scene = SyntheticScene(persons, FW, FH, seed=seed)
    return np.stack([render_frame(scene.step(), FW, FH) for _ in range(n)])


def _pipelines(flat, jtree, precision="fp32", f32_activations=False):
    jpipe = JPosePipeline(JPipelineConfig(
        detector=JDetectorConfig(**DET), model_name=NAME,
        precision=precision), params=jtree,
        dtype=jnp.float32 if f32_activations else None)
    tpipe = PosePipeline(PipelineConfig(
        detector=DetectorConfig(**DET), model_name=NAME,
        precision=precision), params=flat, device="cpu",
        dtype=torch.float32 if f32_activations else None)
    assert tpipe.family == "v11"
    return jpipe, tpipe


def _same_chunks(jpipe, tpipe, frames, k, share=1.0, max_px=KP_TOL):
    """Both pipelines over `frames` in chunks of k: ids, emit and
    num_active equal; poses, boxes and scores within KP_TOL, or, with
    share < 1, that share of them within KP_TOL and all within max_px.
    Returns the tracks emitted."""
    emitted = 0
    for i in range(0, len(frames), k):
        chunk = frames[i:i + k]
        jout = jax.device_get(jpipe.process_chunk(chunk))
        tout = tpipe.process_chunk(chunk)
        for key in ("ids", "emit", "num_active"):
            np.testing.assert_array_equal(tout[key].numpy(),
                                          np.asarray(jout[key]), err_msg=key)
        for key in ("poses", "boxes", "scores"):
            d = np.abs(tout[key].numpy() - np.asarray(jout[key]))
            assert (d <= KP_TOL).mean() >= share and d.max() <= max_px, \
                (key, float((d <= KP_TOL).mean()), float(d.max()))
        emitted += int(tout["emit"].sum())
    return emitted


def test_pipeline_v11_matches_jax(asset):
    """Per frame (process_frame, Kernel 2's tiers on the CPU) and per
    chunk (process_chunk, K = 4), fp32, raw u8 ingest."""
    jpipe, tpipe = _pipelines(*asset)
    n_tracks = []
    for fr in _frames(5):
        jt = jpipe.fetch_outputs(jpipe.process_frame(fr), FW, FH)
        tt = tpipe.fetch_outputs(tpipe.process_frame(fr), FW, FH)
        assert [t.track_id for t in tt] == [t.track_id for t in jt]
        for a, b in zip(tt, jt):
            np.testing.assert_allclose(a.keypoints, b.keypoints, atol=KP_TOL)
            np.testing.assert_allclose(a.bbox, b.bbox, atol=KP_TOL)
        n_tracks.append(len(tt))
    assert n_tracks[-1] >= 3                 # the people are tracked
    jpipe, tpipe = _pipelines(*asset)
    assert _same_chunks(jpipe, tpipe, _frames(8, seed=4), 4) >= 4 * 3


# ---- int8 ------------------------------------------------------------------

@pytest.fixture(scope="module")
def qparams(asset, tmp_path_factory):
    """(the port's calibrated int8 params, JAX's tree with the same scales
    through the calibration cache)."""
    flat, _ = asset
    pq = Q.calibrate_activations(Q.quantize_params(flat), NAME,
                                 calibration_frames(8, 192, seed=1),
                                 device="cpu")
    cache = str(tmp_path_factory.mktemp("int8v11") / "cache.json")
    n = Q.save_calibration_cache(pq, cache)
    jq = JQ.quantize_params(jax_tree(flat, NAME))
    assert JQ.load_calibration_cache(jq, cache) == n
    return pq, jq, n


def test_int8_v11_quantises_and_calibrates_the_depthwise_convs(qparams):
    """Every conv outside b0-b4 is w8a8, the seven depthwise convs (the
    head's six *_dw and the attention's pe) too; prepare_params gives
    those float32 weights holding the int8 values and the dense ones
    Kernel 4's packing."""
    pq, _, n = qparams
    dw = [k for k in Q.conv_paths(pq).values() if L.is_depthwise(k)]
    assert len(dw) == 7 and all(k + ".act_scale" in pq for k in dw)
    p = L.prepare_params(pq, torch.bfloat16, "cpu")
    assert sum(k.endswith(".wdw") for k in p) == 7
    assert sum(k.endswith(".wq") for k in p) == n - 7
    for k in dw:
        w = p[k + ".wdw"]
        assert w.dtype == torch.float32 and w.shape[1] == 1
        assert torch.equal(w, torch.from_numpy(pq[k + ".w"]).float())


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_int8_v11_forward_matches_jax(qparams, precision):
    pq, jq, n = qparams
    tol = {"fp32": 2.5e-2, "bf16": 5e-2}[precision]
    x = calibration_frames(2, 192, seed=9)
    heads_fn, _ = build_model_heads(NAME, JDT[precision])
    want = jax.jit(heads_fn)(jq, jnp.asarray(x))
    params = L.prepare_params(pq, TDT[precision], "cpu")
    seen, conv = [], L.conv_w8a8

    def record(x, *args, **kw):
        seen.append(CI.pixel_stride(x))
        return conv(x, *args, **kw)

    L.conv_w8a8 = record
    try:
        with torch.inference_mode():
            got = forward_heads(params, torch.from_numpy(x).to(
                TDT[precision]), "v11")
    finally:
        L.conv_w8a8 = conv
    # every dense w8a8 conv once, each input in a layout Kernel 4 reads
    assert len(seen) == n - 7 and None not in seen
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w)
        scale = float(np.abs(w).max())
        assert float(err.max()) <= tol * scale, (float(err.max()), scale)
        if precision == "fp32":
            assert (err <= 1e-4 * scale).mean() >= 0.9


def test_int8_v11_differences_start_at_a_rounding_flip(qparams):
    """Where the two packages' int8 forwards part (float32 activations,
    one frame): each quantised conv's float input, the port's by the
    calibration recorder's hook and JAX's by wrapping its conv2d (run op
    by op), in the forward's order. Up to and including the first conv
    whose int8 values differ, every float input agrees within 1e-6 of its
    largest magnitude (oneDNN's and XLA's summation orders), and at that
    conv a handful of values (at most 8) differ by one int8 step: a float
    input an ulp away from a .5 boundary."""
    from posebyte_tpu.models.yolo_pose import forward_heads as j_forward
    pq, jq, _ = qparams
    x = calibration_frames(1, 192, seed=9)
    paths = {id(n): p for p, n in JQ.conv_paths(jq).items()}
    jin, conv = {}, JL.conv2d

    def record(params, v, stride=1, groups=1):
        if "act_scale" in params:
            jin[paths[id(params)]] = np.asarray(v, np.float32)
        return conv(params, v, stride, groups)

    JL.conv2d = record
    try:
        with jax.disable_jit():
            j_forward(jq, jnp.asarray(x), "v11")
    finally:
        JL.conv2d = conv

    order = []

    class Recorder:
        def record(self, key, v):
            if key + ".act_scale" in pq:
                order.append((key, v.permute(0, 2, 3, 1).numpy()))

    L._CALIBRATION_RECORDER = Recorder()
    try:
        with torch.inference_mode():
            forward_heads(L.prepare_params(pq, torch.float32, "cpu"),
                          torch.from_numpy(x), "v11")
    finally:
        L._CALIBRATION_RECORDER = None
    jpath = {k: p for p, k in Q.conv_paths(pq).items()}
    assert len(order) == len(jin)
    for key, got in order:
        want = jin[jpath[key]]
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), key
        s = np.float32(pq[key + ".act_scale"])
        step = np.abs(np.clip(np.round(got / s), -127, 127)
                      - np.clip(np.round(want / s), -127, 127))
        if step.any():
            assert step.max() == 1 and step.sum() <= 8, key
            break


def test_int8_v11_chunk_path_matches_jax(asset, qparams):
    """ids equal; 99% of the pose, box and score values within 1e-2 px,
    all within INT8_KP_MAX_PX (8 px, chip_smoke's int8 card/CPU bar for
    the same mechanism): a few values move by a fraction of a pixel where
    an int8 value flips (test_int8_v11_differences_start_at_a_rounding_flip)
    and the flip runs through the layers after it."""
    pq, jq, _ = qparams
    jpipe, tpipe = _pipelines(pq, jq, precision="int8",
                              f32_activations=True)
    assert tpipe.dtype == torch.float32
    assert _same_chunks(jpipe, tpipe, _frames(8, seed=4), 4, share=0.99,
                        max_px=8.0) >= 4 * 3


def test_int8_v11_frame_path_matches_jax(asset, qparams):
    """The per-frame int8 path (process_frame): ids equal; keypoints and
    boxes within INT8_KP_MAX_PX (8 px) with a median within 0.5 px,
    chip_smoke's int8 card/CPU bars: on these frames the float inputs of
    b5, the first int8 conv, differ by ~1e-6 relative between oneDNN and
    XLA (b0-b4 are float), one value flips, and the flip runs through
    every later layer (test_int8_v11_differences_start_at_a_rounding_flip
    shows the mechanism on one frame)."""
    pq, jq, _ = qparams
    jpipe, tpipe = _pipelines(pq, jq, precision="int8",
                              f32_activations=True)
    d, n_tracks = [], []
    for fr in _frames(5):
        jt = jpipe.fetch_outputs(jpipe.process_frame(fr), FW, FH)
        tt = tpipe.fetch_outputs(tpipe.process_frame(fr), FW, FH)
        assert [t.track_id for t in tt] == [t.track_id for t in jt]
        d += [np.abs(np.concatenate([a.keypoints.ravel(), a.bbox])
                     - np.concatenate([b.keypoints.ravel(), b.bbox]))
              for a, b in zip(tt, jt)]
        n_tracks.append(len(tt))
    d = np.concatenate(d)
    assert np.median(d) <= 0.5 and d.max() <= 8.0, (np.median(d), d.max())
    assert n_tracks[-1] >= 3


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_depthwise_w8a8_route_is_bit_equal(dtype):
    """The depthwise w8a8 route: its float32 conv of the quantised values
    and its plain version (a float64 conv) equal bit for bit, and both
    equal XLA's grouped int8 conv with int32 sums and the JAX w8a8
    epilogue (layers.conv2d with feature_group_count = C, op by op as
    tests/test_torch_conv_int8.py runs the dense one: under jit XLA's CPU
    backend contracts the epilogue's multiply and add into one FMA, where
    the port, as Kernel 4, rounds twice); with ties at (n + 0.5) * s_x and
    values beyond the clamp."""
    rng = np.random.default_rng(6)
    C, s = 48, np.float32(0.05)
    n = rng.integers(-140, 140, (2, 9, 7, C)).astype(np.float32)
    x = (n + np.float32(0.5) * rng.integers(0, 2, n.shape)) * s
    wq = rng.integers(-127, 128, (3, 3, 1, C)).astype(np.int8)     # HWIO
    scale = rng.uniform(0.001, 0.02, C).astype(np.float32)
    b = rng.normal(0, 0.5, C).astype(np.float32)
    jp = {"w": jnp.asarray(wq), "scale": jnp.asarray(scale),
          "act_scale": jnp.asarray(s), "b": jnp.asarray(b)}
    xj = jnp.asarray(x, JDT[dtype])
    want = np.asarray(JL.conv2d(jp, xj, groups=C).astype(jnp.float32))
    xq = jnp.clip(jnp.round(xj.astype(jnp.float32) / s), -127, 127) \
        .astype(jnp.int8)
    sums = np.asarray(lax.conv_general_dilated(
        xq, jnp.asarray(wq), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=C,
        preferred_element_type=jnp.int32))
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        TDT[dtype]).permute(0, 3, 1, 2)
    args = (xt, torch.tensor(s), torch.from_numpy(
        np.ascontiguousarray(np.transpose(wq, (3, 2, 0, 1)))).float(),
        torch.from_numpy(s * scale), torch.from_numpy(b))
    fast = CI.conv_w8a8_depthwise(*args)
    plain = CI.conv_w8a8_depthwise_plain(*args)
    got_sums = CI.conv_w8a8_depthwise_plain(*args, out_dtype=torch.int32)
    assert fast.dtype == plain.dtype == TDT[dtype]
    assert fast.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got_sums.permute(0, 2, 3, 1).numpy(), sums)
    for out in (fast, plain):
        np.testing.assert_array_equal(
            out.float().permute(0, 2, 3, 1).numpy().view(np.int32),
            want.view(np.int32))
    with pytest.raises(TypeError):
        CI.conv_w8a8_depthwise(xt, args[1], args[2][:4], *args[3:])

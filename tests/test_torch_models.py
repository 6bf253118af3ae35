"""Port's weights and YOLOv8-pose forward (posebyte_tpu_torch/models/)
against the JAX package on the trained 256 checkpoint.

Tolerances: weights equal (same float32 values, HWIO -> OIHW); the fp32
forward within 2e-5 of each output's largest magnitude (XLA's and
oneDNN's convolutions sum in different orders across ~60 layers; 1.5e-6
measured); the bf16 forward within 5% of it (bf16 keeps 8 mantissa bits,
and the two frameworks round at different points: XLA rounds the conv and
the bias add separately, PyTorch adds the bias before rounding; 2.3%
measured on the box logits).
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from posebyte_tpu.models import build_model_heads
from posebyte_tpu.models.weights import fold_stem_preprocess as j_fold
from posebyte_tpu.models.weights import load_params as j_load_params

from posebyte_tpu_torch.models import weights as W
from posebyte_tpu_torch.models.yolo_pose import forward_heads, make_anchors

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "yolov8n-pose-synthetic256.safetensors")


@pytest.fixture(scope="module")
def jax_params():
    params, name = j_load_params(ASSET)
    assert name == "yolov8n-pose"
    return params


@pytest.fixture(scope="module")
def port_params():
    params, name = W.load_params(ASSET)
    assert name == "yolov8n-pose"
    return params


def test_safetensors_reader_matches_library():
    from safetensors import safe_open
    flat, meta = W.read_safetensors(ASSET)
    with safe_open(ASSET, framework="numpy") as f:
        assert meta == f.metadata()
        assert set(flat) == set(f.keys())
        for k in f.keys():
            want = f.get_tensor(k)
            assert flat[k].dtype == want.dtype
            np.testing.assert_array_equal(flat[k], want)


def test_safetensors_reader_rejects_truncated(tmp_path):
    blob = open(ASSET, "rb").read()
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(blob[:len(blob) // 2])
    with pytest.raises(ValueError):
        W.read_safetensors(str(bad))


def test_params_from_jax_matches_reader(jax_params, port_params):
    tree = jax.tree.map(np.asarray, jax_params)
    conv = W.params_from_jax(tree)
    assert set(conv) == set(port_params)
    for k, v in port_params.items():
        assert v.dtype == np.float32 and conv[k].shape == v.shape
        np.testing.assert_array_equal(conv[k], v)
    w = port_params["b2.cv1.w"]
    np.testing.assert_array_equal(
        w, np.transpose(np.asarray(jax_params["b2"]["cv1"]["w"]),
                        (3, 2, 0, 1)))


def test_fold_stem_matches_jax(jax_params, port_params):
    want = np.transpose(np.asarray(j_fold(jax_params)["b0"]["w"]),
                        (3, 2, 0, 1))
    got = W.fold_stem_preprocess(port_params)
    np.testing.assert_array_equal(got["b0.w"], want)
    np.testing.assert_array_equal(got["b1.w"], port_params["b1.w"])


def test_make_anchors_matches():
    from posebyte_tpu.models.yolo_pose import make_anchors as j_anchors
    for size in (256, 640):
        for a, b in zip(make_anchors(size), j_anchors(size)):
            np.testing.assert_array_equal(a, b)


def _inputs(seed):
    return np.random.default_rng(seed).uniform(
        0, 1, (1, 256, 256, 3)).astype(np.float32)


def _torch_params(params, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in params.items()}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_heads_matches(jax_params, port_params, precision):
    jdtype = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[precision]
    tdtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[precision]
    tol = {"fp32": 2e-5, "bf16": 5e-2}[precision]
    x = _inputs(0)
    heads_fn, _ = build_model_heads("yolov8n-pose", jdtype)
    want = jax.jit(heads_fn)(jax_params, jnp.asarray(x))
    with torch.inference_mode():
        got = forward_heads(_torch_params(port_params, tdtype),
                            torch.from_numpy(x).to(tdtype))
    for g, w, c in zip(got, want, (64, 1, 51)):
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == (1, 1344, c) and g.dtype == tdtype
        scale = float(np.abs(w).max())
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= tol * scale, (err, scale)


# ---------------------------------------------------------------------------
# The dense output, the head maps and the stem's TPU layouts
# (posebyte_tpu/models/yolo_pose.py:246-414, layers.py:155-247). Tolerances:
# forward_raw within 1e-5 of the output's largest magnitude (the heads'
# 2e-5 bar above, through the DFL expectation and the stride); decode_dense
# of the same heads within 2e-6 relative plus 2e-4 px
# (tests/test_torch_preprocess_decode.py says why); the space-to-depth conv
# and the packed stem within the JAX tests' own 1e-5 (tests/test_models.py:
# float32 sums in another order); the packed stem's heads within 2e-5 of
# the plain stem's, as tests/test_models.py holds JAX's.
# ---------------------------------------------------------------------------

def test_make_anchors_levels_matches():
    from posebyte_tpu.models.yolo_pose import make_anchors_levels as j_lv
    from posebyte_tpu_torch.models.yolo_pose import make_anchors_levels
    for size in (64, 640):
        for (a, s), (ja, js) in zip(make_anchors_levels(size), j_lv(size)):
            np.testing.assert_array_equal(a, ja)
            np.testing.assert_array_equal(s, js)


def test_decode_dense_matches_jax():
    from posebyte_tpu.models.yolo_pose import decode_dense as j_dense
    from posebyte_tpu_torch.models.yolo_pose import decode_dense
    rng = np.random.default_rng(4)
    heads = [rng.normal(0, s, (2, 84, c)).astype(np.float32)
             for s, c in ((2, 64), (2, 1), (1, 51))]
    want = np.asarray(j_dense(*map(jnp.asarray, heads), 64))
    got = decode_dense(*map(torch.from_numpy, heads), 64).numpy()
    assert got.shape == (2, 56, 84)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-4)


def test_forward_raw_matches_jax(jax_params, port_params):
    from posebyte_tpu.models import build_model
    from posebyte_tpu_torch.models.layers import prepare_params
    from posebyte_tpu_torch.models.yolo_pose import build_model as t_build
    x = _inputs(1)
    apply_fn, _ = build_model("yolov8n-pose")
    want = np.asarray(jax.jit(apply_fn)(jax_params, jnp.asarray(x)))
    t_apply, _ = t_build("yolov8n-pose")
    with torch.inference_mode():
        got = t_apply(prepare_params(port_params, torch.float32, "cpu"),
                      torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 56, 1344)
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("C,O,H", [(3, 16, 64), (16, 32, 32), (8, 24, 16)])
def test_conv_s2d_exact(C, O, H):
    from posebyte_tpu.models import layers as JL
    from posebyte_tpu_torch.models import layers as L
    rng = np.random.default_rng(C)
    p = JL.conv_init(jax.random.PRNGKey(C), C, O, 3)
    x = rng.normal(size=(2, H, H, C)).astype(np.float32)
    want = np.asarray(JL.conv_block_s2d(p, jnp.asarray(x)))
    tp = {"c.w": torch.from_numpy(np.transpose(np.array(p["w"]),
                                               (3, 2, 0, 1))),
          "c.b": torch.from_numpy(np.array(p["b"]))}
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = L.conv_block_s2d(tp, "c", xt)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, L.conv_block(tp, "c", xt, 2), rtol=1e-5,
                               atol=1e-5)


def test_conv_s2d_quantized():
    """Weight-only int8 (prepare_params dequantises it) against JAX's s2d
    on the quantised tree."""
    from posebyte_tpu.models import layers as JL
    from posebyte_tpu.models.quant import _quantize_conv as j_quantize
    from posebyte_tpu_torch.models import layers as L
    from posebyte_tpu_torch.models.quant import quantize_params
    p = JL.conv_init(jax.random.PRNGKey(0), 16, 32, 3)
    q = jax.tree.map(jnp.asarray, j_quantize(
        {k: np.asarray(v) for k, v in p.items()}))
    x = np.random.default_rng(1).normal(size=(1, 16, 16, 16)) \
        .astype(np.float32)
    want = np.asarray(JL.conv_block_s2d(q, jnp.asarray(x)))
    flat = quantize_params({"c.w": np.transpose(np.asarray(p["w"]),
                                                (3, 2, 0, 1)),
                            "c.b": np.asarray(p["b"])})
    tp = L.prepare_params(flat, torch.float32, "cpu")
    got = L.conv_block_s2d(tp, "c", torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-4, atol=1e-5)


def test_packed_stem_matches_plain_and_jax():
    """layers.packed_stem (4 frames a grouped conv) against JAX's
    block-diagonal packed_stem and the plain stem; forward_heads with
    packed_stem=4 against the plain heads for both families, and a batch
    that 4 does not divide through the plain stem, bit for bit."""
    from posebyte_tpu.models import layers as JL
    from posebyte_tpu_torch.models import init_params, layers as L
    from posebyte_tpu_torch.models.yolo_pose import MODEL_CONFIGS
    x = np.random.default_rng(1).uniform(0, 1, (8, 64, 64, 3)) \
        .astype(np.float32)
    xt = torch.from_numpy(x)
    for name in ("yolov8n-pose", "yolo11n-pose"):
        flat = init_params(0, name)
        p = L.prepare_params(flat, torch.float32, "cpu")
        nchw = xt.permute(0, 3, 1, 2)
        got = L.packed_stem(p, "b0", "b1", nchw, 4)
        plain = L.conv_block(p, "b1", L.conv_block(p, "b0", nchw, 2), 2)
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
        jp = [{"w": jnp.asarray(np.transpose(flat[f"{k}.w"], (2, 3, 1, 0))),
               "b": jnp.asarray(flat[f"{k}.b"])} for k in ("b0", "b1")]
        want = np.asarray(JL.packed_stem(*jp, jnp.asarray(x), 4))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-5, atol=1e-5)
        fam = MODEL_CONFIGS[name].family
        with torch.inference_mode():
            a = forward_heads(p, xt, fam)
            b = forward_heads(p, xt, fam, packed_stem=4)
            for ref, out in zip(a, b):
                torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)
            c = forward_heads(p, xt[:5], fam, packed_stem=4)
            for ref, out in zip(forward_heads(p, xt[:5], fam), c):
                assert torch.equal(ref, out)

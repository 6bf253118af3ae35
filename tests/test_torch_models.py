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

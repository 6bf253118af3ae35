"""Port's letterbox (ops/preprocess.py) and sparse decode (ops/decode.py,
ops/topk.py) against the JAX package on the same numpy inputs.

Tolerances: letterbox bytes equal (float32 and bf16 outputs); candidate
indices, validity, tie order and scores equal; decoded coordinates within
2e-6 relative plus 2e-4 px absolute: the DFL softmax expectation of XLA's
CPU kernels and PyTorch's differ by a few float32 ulps of a distance up to
15 bins, which the stride (up to 32 px) scales.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from posebyte_tpu.ops.decode import decode_topk as j_decode_topk
from posebyte_tpu.ops.preprocess import letterbox_flat_nhwc as j_letterbox
from posebyte_tpu.ops.preprocess import letterbox_params as j_params
from posebyte_tpu.ops.preprocess import unletterbox_coords as j_unletterbox
from posebyte_tpu.ops.topk import total_order_key as j_key

from posebyte_tpu_torch.ops import decode as D
from posebyte_tpu_torch.ops import preprocess as P
from posebyte_tpu_torch.ops import topk as K

torch.set_num_threads(2)


@pytest.mark.parametrize("w,h,target", [(1280, 720, 640), (1920, 1080, 640),
                                        (1280, 720, 256), (333, 517, 256)])
def test_letterbox_params_match(w, h, target):
    assert P.letterbox_params(w, h, target) == j_params(w, h, target)


@pytest.mark.parametrize("w,h,target,dtype", [
    (1280, 720, 640, "float32"), (1920, 1080, 640, "float32"),
    (1280, 720, 640, "bfloat16"), (1920, 1080, 640, "bfloat16"),
    (333, 517, 256, "float32")])
def test_letterbox_bytes_equal(w, h, target, dtype):
    rng = np.random.default_rng(w + h)
    frame = rng.integers(0, 256, (h * w * 3,), dtype=np.uint8)
    want = np.asarray(j_letterbox(jnp.asarray(frame), w, h, target,
                                  out_dtype=getattr(jnp, dtype),
                                  selection=False, raw=True))
    got = P.letterbox_flat_nhwc(torch.from_numpy(frame), w, h, target,
                                out_dtype=getattr(torch, dtype), raw=True)
    assert got.shape == (target, target, 3)
    got_np = got.float().numpy() if dtype == "bfloat16" else got.numpy()
    np.testing.assert_array_equal(got_np, want.astype(np.float32))


def test_unletterbox_matches():
    xy = np.random.default_rng(0).uniform(0, 640, (5, 17, 2)) \
        .astype(np.float32)
    np.testing.assert_array_equal(
        P.unletterbox_coords(xy, 1280, 720, 640),
        np.asarray(j_unletterbox(jnp.asarray(xy), 1280, 720, 640)))


def test_total_order_key_matches():
    vals = np.array([-1.0, -0.0, 0.0, 1e-45, 0.25, 0.5, 0.5, 1.0, -1.0],
                    np.float32)
    np.testing.assert_array_equal(
        K.total_order_key(torch.from_numpy(vals)).numpy(),
        np.asarray(j_key(jnp.asarray(vals))))


def head_outputs(seed, A=1344, ties=True):
    """Random head outputs for a 256 input (1344 anchors); quantised class
    logits give exact confidence ties."""
    rng = np.random.default_rng(seed)
    box = rng.normal(0, 2, (A, 64)).astype(np.float32)
    cls = rng.normal(-2, 2, (A, 1)).astype(np.float32)
    if ties:
        cls = np.round(cls * 2) / 2
    kpt = rng.normal(0, 1, (A, 51)).astype(np.float32)
    return box, cls, kpt


@pytest.mark.parametrize("seed,ties,k", [(0, True, 256), (1, False, 64),
                                         (2, True, 32)])
def test_decode_topk_matches(seed, ties, k):
    box, cls, kpt = head_outputs(seed, ties=ties)
    jd = j_decode_topk(jnp.asarray(box), jnp.asarray(cls), jnp.asarray(kpt),
                       0.25, k, 256, topk_impl="sort", gather_impl="index")
    td = D.decode_topk(torch.from_numpy(box), torch.from_numpy(cls),
                       torch.from_numpy(kpt), 0.25, k, 256)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    assert 0 < int(td.valid.sum()) <= k
    np.testing.assert_array_equal(td.scores.numpy(), np.asarray(jd.scores))
    for f in ("poses", "boxes"):
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)),
                                   rtol=2e-6, atol=2e-4)


def test_decode_topk_bf16_heads():
    box, cls, kpt = head_outputs(3)
    as_bf16 = [torch.from_numpy(a).to(torch.bfloat16) for a in
               (box, cls, kpt)]
    jd = j_decode_topk(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                         for t in as_bf16), 0.25, 128, 256)
    td = D.decode_topk(*as_bf16, 0.25, 128, 256)
    np.testing.assert_array_equal(td.valid.numpy(), np.asarray(jd.valid))
    np.testing.assert_allclose(td.poses.numpy(), np.asarray(jd.poses),
                               rtol=2e-6, atol=2e-4)

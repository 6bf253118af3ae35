"""The port's normalised letterbox (ops/preprocess.py, raw=False: RGB, 0..1,
LETTERBOX_PAD_VALUE padding) against the JAX package's
letterbox_flat_nhwc(raw=False), letterbox_flat and letterbox_image on the
same numpy frames.

Tolerance: bytes equal, in float32 and bf16, in both lowerings (the
selection lowering where the geometry is an exact decimation; 333x517
needs interpolation and takes the matmul lowering either way), with and
without the BGR -> RGB flip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.ops.preprocess import letterbox_flat as j_letterbox_flat
from posebyte_tpu.ops.preprocess import letterbox_flat_nhwc as j_letterbox
from posebyte_tpu.ops.preprocess import letterbox_image as j_letterbox_image

from posebyte_tpu_torch.core import constants as C
from posebyte_tpu_torch.ops import preprocess as P

torch.set_num_threads(2)

GEOMETRIES = [(1280, 720, 640), (1920, 1080, 640), (333, 517, 256)]


def frame(w, h, seed=0):
    return np.random.default_rng(w * h + seed).integers(
        0, 256, (h * w * 3,), dtype=np.uint8)


def as_f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("w,h,target", GEOMETRIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("selection", [False, True])
@pytest.mark.parametrize("bgr_to_rgb", [True, False])
def test_normalised_letterbox_bytes_equal(w, h, target, dtype, selection,
                                          bgr_to_rgb):
    fr = frame(w, h)
    want = np.asarray(j_letterbox(jnp.asarray(fr), w, h, target,
                                  bgr_to_rgb=bgr_to_rgb,
                                  out_dtype=getattr(jnp, dtype),
                                  selection=selection, raw=False))
    got = P.letterbox_flat_nhwc(torch.from_numpy(fr), w, h, target,
                                bgr_to_rgb=bgr_to_rgb,
                                out_dtype=getattr(torch, dtype),
                                selection=selection)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (target, target, 3)
    np.testing.assert_array_equal(as_f32(got), want.astype(np.float32))


@pytest.mark.parametrize("selection", [False, True])
def test_normalised_letterbox_batch_equals_frames(selection):
    """A leading batch axis gives each frame's letterbox; the pad is
    float32(114 / 255) and the content lies in [0, 1]."""
    w, h, target = 1280, 720, 256
    frames = np.stack([frame(w, h, s) for s in range(3)])
    got = P.letterbox_flat_nhwc(torch.from_numpy(frames), w, h, target,
                                selection=selection)
    assert got.shape == (3, target, target, 3)
    for i in range(3):
        assert torch.equal(got[i], P.letterbox_flat_nhwc(
            torch.from_numpy(frames[i]), w, h, target, selection=selection))
    assert float(got[0, 0, 0, 0]) == np.float32(C.LETTERBOX_PAD_VALUE)
    assert 0.0 <= float(got.min()) and float(got.max()) <= 1.0


@pytest.mark.parametrize("w,h,target", GEOMETRIES)
@pytest.mark.parametrize("selection", [False, True])
def test_letterbox_flat_chw_bytes_equal(w, h, target, selection):
    fr = frame(w, h, 1)
    want = np.asarray(j_letterbox_flat(jnp.asarray(fr), w, h, target,
                                       selection=selection))
    got = P.letterbox_flat(torch.from_numpy(fr), w, h, target,
                           selection=selection)
    assert got.shape == (3, target, target)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,h,target", GEOMETRIES)
@pytest.mark.parametrize("bgr_to_rgb", [True, False])
def test_letterbox_image_bytes_equal(w, h, target, bgr_to_rgb):
    img = frame(w, h, 2).reshape(h, w, 3)
    want = np.asarray(j_letterbox_image(jnp.asarray(img), target,
                                        bgr_to_rgb))
    got = P.letterbox_image(torch.from_numpy(img), target, bgr_to_rgb)
    assert got.shape == (3, target, target) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)

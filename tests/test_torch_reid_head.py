"""The port's learned Re-ID head (posebyte_tpu_torch/models/reid_head.py)
against the JAX package's (posebyte_tpu/models/reid_head.py), with the
trained weights of assets/reid-head-synthetic.safetensors.

Tolerances: the loaded weights equal; the port's one lowering (index
gathers) against both of the JAX package's: patches within 1e-6 of JAX
"direct" and 2e-4 of JAX "block",
embeddings within 1e-5 of JAX "direct" and 1e-4 of JAX "block" (the JAX
package's own bar for its block lowering, whose one-hot contractions
regroup the bilinear blend; tests/test_reid_head.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.models import reid_head as JH

from posebyte_tpu_torch.models import reid_head as H
from posebyte_tpu_torch.models.weights import read_safetensors

torch.set_num_threads(2)

HEAD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "reid-head-synthetic.safetensors")


def edge_stress_poses(rng, n, size):
    """tests/test_reid_head.py::_edge_stress_poses, with gated keypoints."""
    poses = np.ones((n, 17, 3), np.float32)
    poses[:, :, :2] = rng.uniform(-30, size + 30, (n, 17, 2))
    poses[0, :, :2] = rng.uniform(10, size - 10, (17, 2))
    poses[1, :, 0] = rng.uniform(-6, 6, 17)
    poses[2, :, 1] = size - rng.uniform(-6, 6, 17)
    near = rng.integers(1, size - 1, (17, 2)).astype(np.float32)
    poses[3, :, :2] = near - np.float32(1e-6)
    poses[4, :, :2] = near
    poses[6, :, 2] = rng.uniform(0, 0.4, 17)
    return poses


def test_load_matches_jax():
    got = H.load_reid_head(HEAD)
    want = JH.load_reid_head(HEAD)
    assert set(got) == set(want) == {"w1", "b1", "w2", "b2"}
    for k in got:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["w1"].shape == (H.IN_DIM, H.HIDDEN)
    conv = H.reid_head_from_jax(JH.init_reid_head(jax.random.PRNGKey(3)))
    assert conv["w2"].shape == (H.HIDDEN, 3)
    with pytest.raises(ValueError):
        H.reid_head_from_jax({"w1": np.zeros((75, 32), np.float32)})
    assert set(read_safetensors(HEAD)[0]) == set(got)


@pytest.mark.parametrize("raw", [False, True])
def test_patches_and_head_match_jax(raw):
    rng = np.random.default_rng(7 + raw)
    S = 96
    img_u8 = rng.integers(0, 255, (S, S, 3), dtype=np.uint8)
    img = img_u8 if raw else img_u8.astype(np.float32) / np.float32(255.0)
    poses = edge_stress_poses(rng, 8, S)
    ti, tp = torch.from_numpy(img), torch.from_numpy(poses)
    ji, jp = jnp.asarray(img), jnp.asarray(poses)
    params = H.load_reid_head(HEAD)
    jparams = JH.load_reid_head(HEAD)

    patches = H._sample_patches(ti, tp, raw)
    assert patches.shape == (8, 17, H.IN_DIM)
    for impl, atol in (("direct", 1e-6), ("block", 2e-4)):
        want = np.asarray(JH._sample_patches(ji, jp, raw, sample_impl=impl))
        np.testing.assert_allclose(patches.numpy(), want, rtol=0, atol=atol)

    emb = H.apply_reid_head(params, ti, tp, raw_input=raw)
    for impl, atol in (("direct", 1e-5), ("block", 1e-4)):
        want = np.asarray(JH.apply_reid_head(jparams, ji, jp, raw_input=raw,
                                             sample_impl=impl))
        np.testing.assert_allclose(emb.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(np.linalg.norm(emb.numpy(), axis=1), 1.0,
                               atol=1e-5)
    gated = poses[..., 2] <= 0.2
    assert gated.any() and (emb.numpy().reshape(8, 17, 3)[gated] == 0).all()


def test_head_batched_over_frames():
    """A leading frame axis (the chunk path) gives each frame's own
    embeddings."""
    rng = np.random.default_rng(9)
    imgs = torch.from_numpy(rng.integers(0, 255, (3, 48, 48, 3),
                                         dtype=np.uint8))
    poses = torch.from_numpy(np.stack([edge_stress_poses(rng, 7, 48)
                                       for _ in range(3)]))
    params = H.load_reid_head(HEAD)
    batched = H.apply_reid_head(params, imgs, poses, raw_input=True)
    for i in range(3):
        assert torch.equal(batched[i], H.apply_reid_head(
            params, imgs[i], poses[i], raw_input=True))

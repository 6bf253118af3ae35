"""The port's tracker primitives that no path calls yet against the JAX
package on the same numpy inputs: greedy_assign and
filter_matches_by_threshold (ops/assignment.py), oks_distance_matrix and
combine_costs (ops/oks.py), pose_area (ops/geometry.py).

Tolerances: assignments equal; cost matrices and areas within 2e-6
relative plus 1e-7 (the primitive bar of tests/test_torch_tracker.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.ops import assignment as ja
from posebyte_tpu.ops import geometry as jgeo
from posebyte_tpu.ops import oks as joks

from posebyte_tpu_torch.ops import assignment, geometry, oks
from posebyte_tpu_torch.utils.synthetic import POSE_OFFSETS

torch.set_num_threads(2)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-7)


def _poses(rng, n):
    p = np.zeros((n, 17, 3), np.float32)
    p[..., :2] = rng.uniform(80, 560, (n, 1, 2)) + POSE_OFFSETS[None] * \
        rng.uniform(40, 160, (n, 1, 1)) + rng.normal(0, 6, (n, 17, 2))
    p[..., 2] = rng.uniform(0, 1, (n, 17))
    p[0, :, 2] = 0.0                              # nothing visible
    p[1, :15, 2] = 0.1                            # visible above 0.05 only
    p[2, :, 2] = np.where(np.arange(17) < 2, 0.9, 0.0)   # 2 visible
    return p


def test_greedy_assign_unit_case():
    """The JAX test_greedy_assign_globally_sorted case."""
    cost = torch.tensor([[0.3, 0.1], [0.2, 0.15]])
    row, col = assignment.greedy_assign(cost, threshold=0.5)
    assert row.tolist() == [1, 0] and col.tolist() == [1, 0]
    row, col = assignment.greedy_assign(cost, threshold=0.12)
    assert row.tolist() == [1, -1] and col.tolist() == [-1, 0]


@pytest.mark.parametrize("seed,R,C,ties,thr,max_matches", [
    (0, 12, 9, False, 0.6, None), (1, 9, 14, True, 1e9, None),
    (2, 16, 16, True, 0.4, 5), (3, 1, 1, False, 1e9, None)])
def test_greedy_assign_matches_jax(seed, R, C, ties, thr, max_matches):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 1, (R, C)).astype(np.float32)
    if ties:
        cost = (np.round(cost * 4) / 4).astype(np.float32)
    got = assignment.greedy_assign(torch.from_numpy(cost), thr, max_matches)
    want = ja.greedy_assign(jnp.asarray(cost), thr, max_matches)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_filter_matches_by_threshold_matches_jax():
    rng = np.random.default_rng(4)
    dropped = 0
    for R, C in ((12, 9), (6, 10)):
        cost = rng.uniform(0, 1, (R, C)).astype(np.float32)
        row, col = ja.auction_assign(jnp.asarray(cost))
        want = ja.filter_matches_by_threshold(jnp.asarray(cost), row, col,
                                              0.15)
        got = assignment.filter_matches_by_threshold(
            torch.from_numpy(cost), torch.from_numpy(np.array(row)),
            torch.from_numpy(np.array(col)), 0.15)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        dropped += int((got[0] == -1).sum()) - int((np.asarray(row) == -1)
                                                   .sum())
    assert dropped > 0
    # the JAX test_threshold_filter case
    cost = torch.tensor([[0.1, 0.9], [0.9, 0.8]])
    row, col = assignment.filter_matches_by_threshold(
        cost, torch.tensor([0, 1], dtype=torch.int32),
        torch.tensor([0, 1], dtype=torch.int32), 0.5)
    assert row.tolist() == [0, -1] and col.tolist() == [0, -1]


def test_oks_distance_and_combined_costs_match_jax():
    rng = np.random.default_rng(5)
    t, d = _poses(rng, 10), _poses(rng, 8)
    d[3:] = t[3:8] + rng.normal(0, 3, (5, 17, 3)).astype(np.float32)
    d[..., 2] = np.clip(d[..., 2], 0, 1)
    T, D = torch.from_numpy(t), torch.from_numpy(d)
    for scale in (2.0, 3.0):
        _close(oks.oks_distance_matrix(T, D, scale),
               joks.oks_distance_matrix(jnp.asarray(t), jnp.asarray(d),
                                        scale))
    a = rng.uniform(0, 1, (10, 8)).astype(np.float32)
    b = rng.uniform(0, 1, (10, 8)).astype(np.float32)
    for alpha in (0.7, 0.25):
        _close(oks.combine_costs(torch.from_numpy(a), torch.from_numpy(b),
                                 alpha),
               joks.combine_costs(jnp.asarray(a), jnp.asarray(b), alpha))


def test_pose_area_matches_jax():
    rng = np.random.default_rng(6)
    p = _poses(rng, 12)
    for thr in (0.1, 0.5):
        _close(geometry.pose_area(torch.from_numpy(p), thr),
               jgeo.pose_area(jnp.asarray(p), thr))
    assert geometry.pose_area(torch.from_numpy(p))[:3].tolist()[0] == 0.0

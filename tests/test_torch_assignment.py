"""Port's auction (posebyte_tpu_torch/ops/assignment.py) against the JAX
package: the same cost matrices, made from a seed with numpy, through the
JAX auction_assign, the TPU kernel in interpret mode
(auction_assign_pallas) and the port's plain version. Assignments must be
equal. Kernel 2 itself (CUDA) is held against the plain version in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from posebyte_tpu.ops.assignment import auction_assign as j_auction
from posebyte_tpu.ops.pallas_kernels import auction_assign_pallas

from posebyte_tpu_torch.ops import assignment as A

torch.set_num_threads(2)


def make_cost(seed, R, C, locked=0.6, ties=False, inactive=0.1):
    """Tracker-tier cost: ~`locked` of the pairs at 1e9, a fully locked row
    and column, optionally quantised costs (exact ties), inactive rows."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 1, (R, C))
    if ties:
        cost = np.round(cost * 4) / 4
    cost[rng.uniform(size=(R, C)) < locked] = 1e9
    cost[min(3, R - 1), :] = 1e9
    cost[:, min(5, C - 1)] = 1e9
    active = rng.uniform(size=R) >= inactive
    return cost.astype(np.float32), active


CASES = [
    (0, 16, 12, 0.0, False),      # dense: runs the whole round budget
    (1, 24, 16, 0.3, True),
    (2, 128, 64, 0.7, False),     # the tracker's shape
    (3, 128, 64, 0.5, True),
    (4, 7, 30, 0.2, True),        # more columns than rows
]


# Tolerance: none. Assignments are integers and must be equal.
@pytest.mark.parametrize("seed,R,C,locked,ties", CASES)
def test_plain_matches_jax(seed, R, C, locked, ties):
    cost, active = make_cost(seed, R, C, locked, ties)
    jr, jc = j_auction(jnp.asarray(cost), jnp.asarray(active))
    tr, tc = A.auction_assign(torch.from_numpy(cost),
                              torch.from_numpy(active))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tr >= 0).any()


@pytest.mark.parametrize("seed,R,C,locked,ties", CASES[:3])
def test_plain_matches_pallas_interpret(seed, R, C, locked, ties):
    cost, active = make_cost(seed, R, C, locked, ties)
    jr, jc = auction_assign_pallas(jnp.asarray(cost), jnp.asarray(active),
                                   interpret=True)
    tr, tc = A.auction_assign(torch.from_numpy(cost),
                              torch.from_numpy(active))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_early_exit_equals_full_budget():
    """Stopping at the first round without a bid gives the assignment of
    the whole round budget (the JAX version always runs the budget)."""
    cost, active = make_cost(5, 64, 64, 0.9, True)
    c, a = torch.from_numpy(cost), torch.from_numpy(active)
    row, col, rounds = A.auction_assign_rounds(c, a)
    assert rounds < A.auction_iterations(64)
    jr, jc = j_auction(jnp.asarray(cost), jnp.asarray(active))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jc))


def test_inactive_and_locked_rows_never_assigned():
    cost, active = make_cost(6, 32, 16, 0.4, False, inactive=0.3)
    row, col = A.auction_assign(torch.from_numpy(cost),
                                torch.from_numpy(active))
    assert (row[torch.from_numpy(~active)] == -1).all()
    assert row[3] == -1 and col[5] == -1


def test_cuda_wrapper_refuses_cpu_tensors():
    cost, active = make_cost(7, 8, 8)
    with pytest.raises(ValueError):
        A.auction_assign_cuda(torch.from_numpy(cost),
                              torch.from_numpy(active))

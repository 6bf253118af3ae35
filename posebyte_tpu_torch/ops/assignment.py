"""Jacobi auction for the tracker's association tiers, after
posebyte_tpu/ops/assignment.py:38-110 (auction_assign; reference:
hungarian.cu:27-123, 358-405).

Each round, every unassigned active row bids on its best column
(value = -cost - price) by best - second + eps; each column goes to its
highest bid (ties to the lower row) and its price rises by that bid; rows
then re-read their column from the owners. Rows whose best value is a lock
sentinel (<= -1e8) do not bid. eps starts at float32(1/(R+1)) and shrinks
by 0.9 per round, for at most min(3R, 50) rounds. A round without bidders
changes nothing, so both versions stop there; the assignment is the one
the fixed round budget gives.

auction_assign_cuda is Kernel 2 (csrc/auction.cu) on CUDA tensors;
auction_assign is its plain version. The tracker picks one by device
(tracker/step.py::_auction). greedy_assign and filter_matches_by_threshold
are the reference's host-side matcher family (assignment.py:112-166 of the
JAX package); no path of the pipeline calls them.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib

_NEG = -1e9
# Largest dynamic shared memory a block may use on Hopper (232,448 bytes).
_MAX_SMEM = 232448


def auction_iterations(num_rows: int) -> int:
    """Round budget (reference: hungarian.cu:379)."""
    return min(num_rows * 3, 50)


def auction_assign_rounds(cost: torch.Tensor,
                          row_active: torch.Tensor | None = None,
                          num_iters: int | None = None):
    """Plain auction on cost [R, C] float32 and row_active [R] bool ->
    (row_assign [R] int32, col_assign [C] int32, rounds with a bid)."""
    R, Cc = cost.shape
    dev = cost.device
    if num_iters is None:
        num_iters = auction_iterations(R)
    if row_active is None:
        row_active = torch.ones((R,), dtype=torch.bool, device=dev)
    row_ids = torch.arange(R, dtype=torch.int32, device=dev)
    col_ids = torch.arange(Cc, dtype=torch.int64, device=dev)
    row_assign = torch.full((R,), -1, dtype=torch.int32, device=dev)
    col_assign = torch.full((Cc,), -1, dtype=torch.int32, device=dev)
    prices = torch.zeros((Cc,), dtype=torch.float32, device=dev)
    eps = np.float32(1.0 / (R + 1))
    rounds = 0
    for _ in range(num_iters):
        value = -cost - prices[None, :]                          # [R, C]
        best_col = value.argmax(dim=1)                           # first max
        best_val = value.amax(dim=1)
        bidder = (row_assign < 0) & row_active & (best_val > -1e8)
        if not bool(bidder.any()):
            break
        rounds += 1
        is_best = col_ids[None, :] == best_col[:, None]
        second_val = torch.where(is_best, _NEG, value).amax(dim=1)
        bid = best_val - second_val + float(eps)                 # [R]

        bid_matrix = torch.where(is_best & bidder[:, None], bid[:, None],
                                 _NEG)
        col_best = bid_matrix.amax(dim=0)                        # [C]
        col_bidder = bid_matrix.argmax(dim=0).to(torch.int32)    # first max
        col_won = col_best > _NEG / 2
        col_assign = torch.where(col_won, col_bidder, col_assign)
        prices = torch.where(col_won, prices + col_best, prices)

        owned = col_assign[None, :] == row_ids[:, None]          # [R, C]
        first = owned.to(torch.uint8).argmax(dim=1).to(torch.int32)
        row_assign = torch.where(owned.any(dim=1), first, -1)
        eps = np.float32(eps * np.float32(0.9))
    return row_assign, col_assign, rounds


def auction_assign(cost: torch.Tensor, row_active: torch.Tensor | None = None,
                   num_iters: int | None = None):
    """Plain auction -> (row_assign [R] int32, col_assign [C] int32), -1
    where unassigned."""
    row, col, _ = auction_assign_rounds(cost, row_active, num_iters)
    return row, col


def auction_assign_cuda(cost: torch.Tensor,
                        row_active: torch.Tensor | None = None,
                        num_iters: int | None = None,
                        rounds: torch.Tensor | None = None):
    """Kernel 2 on CUDA tensors: cost [B, R, C] float32, row_active [B, R]
    bool or None (every row active; the kernel gets a null pointer), the
    batch axis may be left out -> (row_assign [B, R] int32, col_assign
    [B, C] int32), views of one allocation. rounds: optional [B] int32
    tensor on the cost's device that receives each matrix's rounds with a
    bid (the count auction_assign_rounds returns); no pipeline path asks
    for it. Launches on the cost device's current stream. Raises on a bad
    input or a launch error."""
    unbatched = cost.dim() == 2
    if unbatched:
        cost = cost[None]
        row_active = None if row_active is None else row_active[None]
    if not cost.is_cuda or cost.dim() != 3:
        raise ValueError("auction_assign_cuda: cost must be a [B, R, C] or "
                         "[R, C] CUDA tensor")
    B, R, Cc = cost.shape
    if cost.dtype != torch.float32 or (row_active is not None and
                                       row_active.dtype != torch.bool):
        raise TypeError("auction_assign_cuda: cost float32, row_active bool")
    if row_active is not None and (row_active.shape != (B, R) or
                                   row_active.device != cost.device):
        raise ValueError("auction_assign_cuda: row_active must be [B, R] on "
                         "the cost's device")
    if not (cost.is_contiguous() and (row_active is None or
                                      row_active.is_contiguous())):
        raise ValueError("auction_assign_cuda: inputs must be contiguous")
    if rounds is not None and (rounds.shape != (B,) or rounds.dtype !=
                               torch.int32 or rounds.device != cost.device):
        raise ValueError("auction_assign_cuda: rounds must be [B] int32 on "
                         "the cost's device")
    lib = cuda_lib.load()
    if min(B, R, Cc) <= 0 or lib.posebyte_auction_smem_bytes(R, Cc) > \
            _MAX_SMEM:
        raise ValueError(f"auction_assign_cuda: shape {tuple(cost.shape)} "
                         "does not fit one block's shared memory")
    if num_iters is None:
        num_iters = auction_iterations(R)
    eps0 = float(np.float32(1.0 / (R + 1)))
    out = torch.empty(B * (R + Cc), dtype=torch.int32, device=cost.device)
    status = lib.posebyte_auction(
        cost.data_ptr(), None if row_active is None else
        row_active.data_ptr(), out.data_ptr(), out.data_ptr() + 4 * B * R,
        B, R, Cc, int(num_iters), eps0,
        None if rounds is None else rounds.data_ptr(),
        torch.cuda.current_stream(cost.device).cuda_stream)
    cuda_lib.check(status, "auction")
    auction_assign_cuda.launches += 1
    row, col = out[:B * R].view(B, R), out[B * R:].view(B, Cc)
    return (row[0], col[0]) if unbatched else (row, col)


auction_assign_cuda.launches = 0


def filter_matches_by_threshold(cost: torch.Tensor, row_assign: torch.Tensor,
                                col_assign: torch.Tensor, threshold: float):
    """Drop the matches whose cost exceeds `threshold`, in both directions
    (reference: the host solver's post-filter, hungarian.cu:324-336)."""
    C = cost.shape[1]
    safe_col = row_assign.clamp(0, C - 1).long()
    match_cost = cost.gather(1, safe_col[:, None])[:, 0]
    bad = (row_assign >= 0) & (match_cost > threshold)
    bad_cols = torch.zeros((C,), dtype=torch.int32, device=cost.device) \
        .scatter_reduce(0, safe_col, bad.to(torch.int32), "amax") > 0
    return (torch.where(bad, -1, row_assign),
            torch.where(bad_cols, -1, col_assign))


def greedy_assign(cost: torch.Tensor, threshold: float = 1e9,
                  max_matches: int | None = None):
    """Globally ordered greedy assignment: take the cheapest remaining
    (row, column) pair under `threshold` (the first in row-major order on
    ties), up to max_matches (default min(R, C)) times (reference:
    kernelGreedyMatch and the sorted CPU fallback, hungarian.cu:126-157,
    454-518) -> (row_assign [R], col_assign [C]) int32, -1 unmatched."""
    R, C = cost.shape
    if max_matches is None:
        max_matches = min(R, C)
    i32 = dict(dtype=torch.int32, device=cost.device)
    row = torch.full((R,), -1, **i32)
    col = torch.full((C,), -1, **i32)
    cur = cost.to(torch.float32).clone()
    for _ in range(max_matches):
        idx = int(cur.reshape(-1).argmin())
        r, c = divmod(idx, C)
        if not bool(cur[r, c] < threshold):
            break            # nothing under the threshold is left
        row[r], col[c] = c, r
        cur[r, :] = float("inf")
        cur[:, c] = float("inf")
    return row, col

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
(tracker/step.py::_auction).
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
                        num_iters: int | None = None):
    """Kernel 2 on CUDA tensors: cost [B, R, C] float32, row_active [B, R]
    bool (the batch axis may be left out) -> (row_assign [B, R] int32,
    col_assign [B, C] int32). Raises on a bad input or a launch error."""
    unbatched = cost.dim() == 2
    if unbatched:
        cost = cost[None]
        row_active = None if row_active is None else row_active[None]
    if not cost.is_cuda or cost.dim() != 3:
        raise ValueError("auction_assign_cuda: cost must be a [B, R, C] or "
                         "[R, C] CUDA tensor")
    B, R, Cc = cost.shape
    if row_active is None:
        row_active = torch.ones((B, R), dtype=torch.bool, device=cost.device)
    if cost.dtype != torch.float32 or row_active.dtype != torch.bool:
        raise TypeError("auction_assign_cuda: cost float32, row_active bool")
    if row_active.shape != (B, R) or row_active.device != cost.device:
        raise ValueError("auction_assign_cuda: row_active must be [B, R] on "
                         "the cost's device")
    if not (cost.is_contiguous() and row_active.is_contiguous()):
        raise ValueError("auction_assign_cuda: inputs must be contiguous")
    lib = cuda_lib.load()
    if min(B, R, Cc) <= 0 or lib.posebyte_auction_smem_bytes(R, Cc) > \
            _MAX_SMEM:
        raise ValueError(f"auction_assign_cuda: shape {tuple(cost.shape)} "
                         "does not fit one block's shared memory")
    if num_iters is None:
        num_iters = auction_iterations(R)
    eps0 = float(np.float32(1.0 / (R + 1)))
    row = torch.empty((B, R), dtype=torch.int32, device=cost.device)
    col = torch.empty((B, Cc), dtype=torch.int32, device=cost.device)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.posebyte_auction(
            cost.data_ptr(), row_active.data_ptr(), row.data_ptr(),
            col.data_ptr(), B, R, Cc, int(num_iters), eps0, stream)
    cuda_lib.check(status, "auction")
    auction_assign_cuda.launches += 1
    return (row[0], col[0]) if unbatched else (row, col)


auction_assign_cuda.launches = 0

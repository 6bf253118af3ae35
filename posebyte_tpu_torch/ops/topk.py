"""Exact top-k for the decode confidence ranking, with lax.top_k's order.

lax.top_k (the JAX package's topk_impl="sort") returns values in
descending order with ties to the lower index, comparing floats by a
bit-level total order (-0.0 < +0.0). torch.topk promises no tie order, so
the port sorts a total-order integer key with a stable sort
(posebyte_tpu/ops/topk.py::total_order_key).
"""
from __future__ import annotations

import torch


def total_order_key(r32: torch.Tensor) -> torch.Tensor:
    """Order-preserving non-negative int32 key on the decode ranking domain
    (every negative entry equals one filler value; non-negative entries
    are any finite floats): negative -> 0, -0.0 -> 1, x >= +0.0 ->
    bits(x) + 2."""
    r32 = r32.to(torch.float32).contiguous()
    bits = r32.view(torch.int32)
    zero = torch.zeros_like(bits)
    return torch.where(bits >= 0, bits + 2,
                       torch.where(r32 == 0, zero + 1, zero))


def topk_confidence(ranked: torch.Tensor, k: int, impl: str = "sort"):
    """(values, indices) of the k largest entries along the last axis of
    `ranked`, descending, ties to the lower index: lax.top_k's result."""
    if impl != "sort":
        raise NotImplementedError(f"topk_impl {impl!r} is not ported; "
                                  "use 'sort'")
    key = total_order_key(ranked)
    idx = torch.sort(-key, dim=-1, stable=True).indices[..., :k]
    return ranked.gather(-1, idx), idx

"""Exact top-k for the decode confidence ranking, with lax.top_k's order,
after posebyte_tpu/ops/topk.py.

lax.top_k (the JAX package's topk_impl="sort") returns values in
descending order with ties to the lower index, comparing floats by a
bit-level total order (-0.0 < +0.0). torch.topk promises no tie order, so
the port sorts a total-order integer key with a stable sort
(posebyte_tpu/ops/topk.py::total_order_key).

topk_impl picks the lowering (core.config.DetectorConfig.topk_impl):
  - "sort"   a stable sort of the key;
  - "bisect" the MSB radix-select of topk_masked_bisect (31 count passes,
    then a k-element two-key sort), bit-identical to "sort";
  - "approx" lax.approx_max_k in the JAX package, the TPU's PartialReduce.
    Off the TPU approx_max_k is the exact top-k, so the port computes it
    as "sort" does (tests/test_torch_decode_variants.py holds it to JAX's
    CPU result).
All three take leading batch axes (a chunk's frames), as JAX's vmap does.
"""
from __future__ import annotations

import torch

IMPLS = ("sort", "bisect", "approx")


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


def onehot_select(onehot_bool: torch.Tensor,
                  payload: torch.Tensor) -> torch.Tensor:
    """The JAX package's one-hot selection matmul, bool [..., K, A] x
    [..., A, C] -> float32 [..., K, C], as an index gather: row r takes the
    payload row of its True column (at most one per row), widened to
    float32, or zeros where the row has none.

    The values are those of JAX's Precision.HIGHEST matmul on finite
    payloads, up to the sign of a zero (the matmul's sum of +0.0 terms
    turns a selected -0.0 into +0.0) and the TPU MXU's flush of subnormal
    entries (ops/decode.py::decode_topk's docstring). The port gathers by
    index everywhere; this function stands for the JAX one where a caller
    names it."""
    has = onehot_bool.any(dim=-1, keepdim=True)                 # [.., K, 1]
    idx = onehot_bool.to(torch.uint8).argmax(dim=-1)            # [.., K]
    rows = payload.float().gather(
        -2, idx[..., None].expand(*idx.shape, payload.shape[-1]))
    return torch.where(has, rows, 0.0)


def _sorted_by_key(key: torch.Tensor, idx: torch.Tensor, k: int):
    """Positions of the k entries of (key, idx) pairs in the order
    (descending key, ascending idx): one sort of a composite int64 key
    (-key) * 2^32 + idx, unique per entry, so any sort gives the order."""
    comp = (-key.to(torch.int64)) * (1 << 32) + idx.to(torch.int64)
    return torch.sort(comp, dim=-1).indices[..., :k]


def topk_masked_bisect(ranked: torch.Tensor, k: int):
    """lax.top_k(ranked, k) along the last axis, for `ranked` whose negative
    entries all equal one filler value, by MSB radix-select
    (posebyte_tpu/ops/topk.py:77-131):

    1. 31 count passes find the k-th largest total-order key p: bit b from
       30 down to 0 is set where at least k keys reach p | 2^b;
    2. the keys above p, then the earliest ties equal to p, make exactly k
       selected entries, compacted in index order by a scatter into k + 1
       slots (the unselected ones land in the dropped last slot);
    3. a k-element two-key sort gives lax.top_k's order.

    Every count stays a tensor on the device: no host synchronisation and
    no branch on a count. Returns (values in ranked's dtype, int64
    indices), bit-identical to topk_confidence(..., "sort")."""
    A = ranked.shape[-1]
    if k >= A:
        return topk_confidence(ranked, k, "sort")
    lead = ranked.shape[:-1]
    r32 = ranked.to(torch.float32)
    key = total_order_key(r32)                                  # [.., A]
    p = torch.zeros((*lead, 1), dtype=torch.int32, device=key.device)
    for b in range(30, -1, -1):
        t = p | (1 << b)
        cnt = (key >= t).sum(dim=-1, keepdim=True)
        p = torch.where(cnt >= k, t, p)
    greater = key > p
    m = greater.sum(dim=-1, keepdim=True)
    equal = key == p
    sel = greater | (equal & (torch.cumsum(equal, dim=-1) <= k - m))
    pos = torch.cumsum(sel, dim=-1) - 1
    dest = torch.where(sel, pos, k)
    arange = torch.arange(A, device=key.device).expand(*lead, A)
    idx_io = torch.zeros((*lead, k + 1), dtype=torch.int64,
                         device=key.device).scatter_(-1, dest, arange)
    idx_io = idx_io[..., :k]                                    # index order
    order = _sorted_by_key(key.gather(-1, idx_io), idx_io, k)
    idx = idx_io.gather(-1, order)
    return ranked.gather(-1, idx), idx


def topk_confidence(ranked: torch.Tensor, k: int, impl: str = "sort"):
    """(values, indices) of the k largest entries along the last axis of
    `ranked`, descending, ties to the lower index: lax.top_k's result, by
    the lowering `impl` names ("sort", "bisect" or "approx", the module
    docstring)."""
    if impl == "bisect":
        return topk_masked_bisect(ranked, k)
    if impl not in IMPLS:
        raise ValueError(f"unknown topk_impl {impl!r} "
                         "(expected sort|bisect|approx)")
    key = total_order_key(ranked)
    idx = torch.sort(-key, dim=-1, stable=True).indices[..., :k]
    return ranked.gather(-1, idx), idx

// Jacobi auction over one cost matrix, as a __device__ function that the
// standalone auction kernel (auction.cu) and the fused tracker kernel share.
//
// Replaces the body of posebyte_tpu/ops/pallas_kernels.py::auction_rounds
// (used by auction_assign_pallas and tracker_chunk_pallas) with the
// semantics of posebyte_tpu/ops/assignment.py::auction_assign:
//   value = -cost - price; a row bids when it is unassigned, active and its
//   best value is > -1e8 (locked pairs carry cost 1e9); bid = best - second
//   + eps, where second is the best value with the best column masked to
//   -1e9; each column goes to its highest bid (ties to the lower row), its
//   price rises by that bid, and every row re-reads its column from the
//   owners. eps starts at eps0 = float32(1/(R+1)) and is multiplied by 0.9f
//   after every round. At most num_iters rounds; a round in which no row
//   bids changes nothing, so the loop stops there.
//
// Returns the number of rounds that awarded bids (num_iters when the
// budget ran out), the same on every thread.
//
// Every thread of the block must call it: it synchronises the block. The
// exit decision is block-uniform by construction (__syncthreads_or), so no
// thread leaves the round loop while others wait at a barrier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace posebyte {

constexpr float kAuctionNeg = -1e9f;

// Lanes that compute one row's bid: the least power of two, at most 32,
// that leaves each lane at most 8 columns to scan.
__host__ __device__ inline int auction_group(int C) {
  int g = 1;
  while (g < 32 && g * 8 < C) g *= 2;
  return g;
}

// All arrays live in shared memory.
//   cost      [R][C]  row-major, so that the lanes of a bid read
//                     consecutive words (no bank conflicts)
//   active    [R]     nonzero where the row may bid; null: every row
//   row_assign[R], col_assign[C]   outputs, -1 where unassigned
//   prices    [C], col_bid [C]     scratch
//
// A round: groups of auction_group(C) lanes take the rows in turn (the
// loop over rows runs the same number of times on every thread, so every
// lane reaches every shuffle; a warp none of whose rows bids skips to
// its next rows, which after the first round is most). Lane l of a group scans columns l, l + G,
// ... in order, keeping its best (a strict >: ties stay with the lower
// column) and its second best; a butterfly of shuffles merges the lanes:
// the larger best wins, ties to the lower column, and the loser's best
// joins the seconds. fmaxf is exact, so best, its column and second are
// those of one scan over all C columns in order, whatever the order of
// the merge. The row's first lane folds (bid, lowest row first) into its
// column's 64-bit key with atomicMax -- the high word is the bid's float
// bits (bids are > 0, so the bits order like the values), the low word
// ~row, so equal bids go to the lower row, as the JAX argmax does. The
// maximum does not depend on the order of the atomics, so the result is
// deterministic. Each column then takes its winner and evicts its
// previous owner. A row owns at most one column (only unassigned rows
// bid, each on one column), so this update equals re-reading every row's
// column from the owners.
__device__ inline int auction_rounds(const float* cost,
                                     const uint8_t* active, int R, int C,
                                     int num_iters, float eps0,
                                     int* row_assign, int* col_assign,
                                     float* prices,
                                     unsigned long long* col_bid) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int r = tid; r < R; r += nth) row_assign[r] = -1;
  for (int c = tid; c < C; c += nth) {
    col_assign[c] = -1;
    prices[c] = 0.0f;
    col_bid[c] = 0ull;
  }
  __syncthreads();

  const int G = auction_group(C);
  const int gl = tid & (G - 1), ngrp = nth / G;
  float eps = eps0;
  int it = 0;
  for (; it < num_iters; ++it) {
    int any_bid = 0;
    for (int base = 0; base < R; base += ngrp) {
      const int r = base + tid / G;
      const bool bids = r < R && row_assign[r] < 0 &&
                        (active == nullptr || active[r] != 0);
      if (!__any_sync(0xffffffffu, bids)) continue;  // the warp's rows: none
      float best = -INFINITY, second = kAuctionNeg;
      int best_c = C;
      if (bids) {
        const float* cr = cost + (size_t)r * C;
        for (int c = gl; c < C; c += G) {
          const float v = -cr[c] - prices[c];
          if (v > best) {  // strict: ties go to the lower column
            second = fmaxf(second, best);
            best = v;
            best_c = c;
          } else {
            second = fmaxf(second, v);
          }
        }
      }
      for (int off = G >> 1; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const float os = __shfl_xor_sync(0xffffffffu, second, off);
        const int oc = __shfl_xor_sync(0xffffffffu, best_c, off);
        const bool take = ob > best || (ob == best && oc < best_c);
        second = fmaxf(second, fmaxf(os, take ? best : ob));
        if (take) {
          best = ob;
          best_c = oc;
        }
      }
      if (bids && gl == 0 && best > -1e8f) {  // locked pairs never bid
        const float bid = (best - second) + eps;
        const unsigned long long key =
            (static_cast<unsigned long long>(__float_as_uint(bid)) << 32) |
            (0xffffffffu - static_cast<unsigned>(r));
        atomicMax(&col_bid[best_c], key);
        any_bid = 1;
      }
    }
    // Barrier and block-wide OR in one: every thread gets the same answer.
    if (!__syncthreads_or(any_bid)) break;

    // Awarding: one thread per column.
    for (int c = tid; c < C; c += nth) {
      const unsigned long long key = col_bid[c];
      if (key != 0ull) {
        const int winner =
            static_cast<int>(0xffffffffu - static_cast<unsigned>(key));
        const int old = col_assign[c];
        if (old >= 0) row_assign[old] = -1;
        row_assign[winner] = c;
        col_assign[c] = winner;
        prices[c] = prices[c] + __uint_as_float(
                                    static_cast<unsigned>(key >> 32));
        col_bid[c] = 0ull;
      }
    }
    __syncthreads();
    eps = eps * 0.9f;
  }
  return it;
}

}  // namespace posebyte

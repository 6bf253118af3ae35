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
// Every thread of the block must call it: it synchronises the block. The
// exit decision is block-uniform by construction (__syncthreads_or), so no
// thread leaves the round loop while others wait at a barrier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace posebyte {

constexpr float kAuctionNeg = -1e9f;

// All arrays live in shared memory.
//   cost_t    [C][R]  cost transposed, so that row threads read
//                     consecutive words (no bank conflicts)
//   active    [R]     nonzero where the row may bid
//   row_assign[R], col_assign[C]   outputs, -1 where unassigned
//   prices    [C], col_bid [C]     scratch
//
// A round: each bidding row folds (bid, lowest row first) into its column's
// 64-bit key with atomicMax -- the high word is the bid's float bits (bids
// are > 0, so the bits order like the values), the low word ~row, so equal
// bids go to the lower row, as the JAX argmax does. The maximum does not
// depend on the order of the atomics, so the result is deterministic. Each
// column then takes its winner and evicts its previous owner. A row owns at
// most one column (only unassigned rows bid, each on one column), so this
// update equals re-reading every row's column from the owners.
__device__ inline void auction_rounds(const float* cost_t,
                                      const uint8_t* active, int R, int C,
                                      int num_iters, float eps0,
                                      int* row_assign, int* col_assign,
                                      float* prices,
                                      unsigned long long* col_bid) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) row_assign[r] = -1;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    col_assign[c] = -1;
    prices[c] = 0.0f;
    col_bid[c] = 0ull;
  }
  __syncthreads();

  float eps = eps0;
  for (int it = 0; it < num_iters; ++it) {
    // Bidding: one thread per row; best and second best in one pass.
    int any_bid = 0;
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      if (row_assign[r] >= 0 || active[r] == 0) continue;
      float best = -cost_t[r] - prices[0];
      int best_c = 0;
      float second = kAuctionNeg;  // the best column's value, masked
      for (int c = 1; c < C; ++c) {
        const float v = -cost_t[c * R + r] - prices[c];
        if (v > best) {  // strict: ties go to the lower column
          second = fmaxf(second, best);
          best = v;
          best_c = c;
        } else {
          second = fmaxf(second, v);
        }
      }
      if (best > -1e8f) {  // locked pairs (1e9) never draw a bid
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
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
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
}

}  // namespace posebyte

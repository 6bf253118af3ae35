// Kernel 2: the auction of one tracker association tier.
//
// Replaces posebyte_tpu/ops/pallas_kernels.py::auction_assign_pallas
// (_auction_kernel + auction_rounds): a Jacobi auction over the [R, C]
// track x detection cost matrix, all rounds in one launch, with the
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
// What bounds it on an H100: neither bytes nor arithmetic but latency. At
// the tracker's shape (R = 128 tracks, C = 64 detections) it reads 33 KB
// and writes 0.8 KB, and a round is ~8 R C operations; the rounds are
// sequential, and each is a chain of dependent shared-memory steps.
//
// Design (v2): one block of kThreads threads per cost matrix (grid =
// batch). They copy the matrix into shared memory once, 16 bytes a load
// where C and the address allow, its rows row_stride(C) floats apart where
// that still fits (the lane groups of a warp, each on its own row, then
// read different banks), else packed. The rows that may bid (unassigned,
// active, not dropped) are one bit each in `bidders`, kept across rounds:
// set from `active` once, and changed only at the award. A round:
//  1 ranks: every warp reads the same bidder words; lane i holds word i
//    and the count of set bits up to it (a scan of shuffles), so n, the
//    bidders' count, is the same on every warp. No barrier and no list.
//  2 bids: lane groups of G = auction_group(C) lanes (4 at C = 64), 32 / G
//    a warp, kThreads / G a pass of the block. Where fewer than half the
//    rows bid, the groups take the bidders by rank: each finds its row,
//    the k-th set bit, by a binary search over the lanes' counts and one
//    within the word (nth_bidder), so only rows that may bid are scanned
//    and the other warps go straight to the barrier. Else (the search
//    would cost more than it saves) the groups take the rows in turn, and
//    a warp none of whose rows may bid skips them. The choice is n's, the
//    same on every warp; both give the same bids (group_bid). Lane l of a
//    group loads columns l, l + G, ... 8 at a time and scans them in
//    order, keeping its best (a strict >: ties stay with the lower column)
//    and second best; a butterfly of shuffles merges the lanes (the larger
//    best wins, ties to the lower column, the loser's best joins the
//    seconds). fmaxf is exact, so best, its column and second are those of
//    one scan over all C columns in order. The group's first lane folds (bid, row) into its column's
//    64-bit key by atomicMax: the high word the bid's float bits (bids are
//    > 0, so the bits order like the values), the low word row_key(row),
//    so equal bids go to the lower row, as the JAX argmax does. The
//    maximum does not depend on the atomics' order: the result is
//    deterministic. A row whose best value is <= -1e8 is dropped for good
//    (a bit in `drops`, applied at the award, so that no warp's ranks
//    change mid-round). This is bit-equal: prices only rise (a bid is
//    > 0), float subtraction is monotone, so each of the row's values
//    -cost - price only falls, its best can never again pass -1e8, and the
//    plain version would skip it in every later round.
//  3 __syncthreads_or of "some row bid", a barrier whose answer is the
//    same on every thread: a round without a bid ends the loop.
//  4 awarding: threads over columns; a column with a bid takes its winner
//    (its bit cleared), evicts its previous owner (its bit set: it may bid
//    again) and raises its price. A row owns at most one column (only
//    unassigned rows bid, each on one column), so this equals re-reading
//    every row's column from the owners. Then the round's drops, and a
//    barrier. Two barriers a round.
// Each row's column is read from the owners once, after the last round.
// Shared memory: 4 S bytes a row, 16 a column and 8 per 32 rows. Where S
// is C that is no more than the 1024-thread v1's (4 C + 5 a row, 16 a
// column) but for 3 bytes at R = 1, so every shape v1 took still fits
// (tests hold this for every R).
// Measured against this on the card (PERF.md §6, PR 12): the 1024-thread
// v1 that walked every row each round (slower on every case measured);
// one warp running every round after the copy (4.6x slower on the stress
// case); a list of the bidders rebuilt by every warp each round by R / 32
// ballots, with two 32-bit atomics in place of the key (16 ints a row of
// shared memory, +57% on 1030 rows); the bidders always by rank, or always
// row by row; ranks wherever they save a pass; 8 columns a lane; 512
// threads. The kernel allocates nothing: the wrapper hands it the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kNeg = -1e9f;
// The most dynamic shared memory a block may take on Hopper (227 KB).
constexpr size_t kMaxSmem = 232448;

// Lanes that compute one row's bid: the least power of two, at most 32,
// that leaves each lane at most 16 columns to scan (two steps of 8 loads).
__device__ inline int auction_group(int C) {
  int g = 1;
  while (g < 32 && g * 16 < C) g *= 2;
  return g;
}

// Floats between two rows of the padded matrix: C rounded up to 4
// (16-byte rows), plus 8 where that is a multiple of 32.
__host__ __device__ inline int row_stride(int C) {
  const int s = (C + 3) & ~3;
  return s % 32 == 0 ? s + 8 : s;
}

__host__ __device__ inline int words(int R) { return (R + 31) >> 5; }

// The low word of a column's key: the largest for the lowest row, so that
// the key's maximum takes equal bids' lowest row. Its own inverse.
__device__ inline unsigned row_key(unsigned r) { return 0xffffffffu - r; }

// Byte offsets of the block's shared memory: the columns' keys [C] (u64)
// at 0, the matrix [R][S] (S floats a row), prices [C], col_assign [C],
// then the bidder bits and this round's drops, [words(R)] each.
struct Layout {
  size_t cost, price, col, bid, drop, total;
  __host__ __device__ Layout(int R, int C, int S) {
    cost = (size_t)C * sizeof(unsigned long long);
    price = cost + (size_t)R * S * sizeof(float);
    col = price + (size_t)C * sizeof(float);
    bid = col + (size_t)C * sizeof(int);
    drop = bid + (size_t)words(R) * sizeof(unsigned);
    total = drop + (size_t)words(R) * sizeof(unsigned);
  }
};

// The row stride a launch uses: padded where that layout fits, else C.
int plan_stride(int R, int C) {
  return Layout(R, C, row_stride(C)).total <= kMaxSmem ? row_stride(C) : C;
}

// Lane i's count of set bits in the warp's words 0..i.
__device__ inline int inclusive_count(unsigned w, int lane) {
  int x = __popc(w);
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Position of the n-th (from 0) set bit of w; n < __popc(w).
__device__ inline int nth_bit(unsigned w, int n) {
  int pos = 0;
  for (int s = 16; s > 0; s >>= 1) {
    const int low = __popc(w & ((1u << s) - 1u));
    if (n >= low) {
      n -= low;
      w >>= s;
      pos += s;
    }
  }
  return pos;
}

// The row of the k-th (from 0) set bit of bits[0, nw), in row order, or -1
// where fewer are set. Every lane of the warp calls it, each with its own
// k; lane i brings word i (w) and inclusive_count of it (incl). Words past
// the first 32 are read 32 at a time, while some lane's row is not found.
__device__ inline int nth_bidder(const unsigned* bits, int nw, unsigned w,
                                 int incl, int k, int lane) {
  int row = -1;
  for (int w0 = 0;;) {
    const int total = __shfl_sync(kAll, incl, 31);
    int j = 0;  // this chunk's words whose bits all rank below k
    for (int s = 16; s > 0; s >>= 1) {
      const int v = __shfl_sync(kAll, incl, j + s - 1);
      if (v <= k) j += s;
    }
    const unsigned wj = __shfl_sync(kAll, w, j);
    const int below = __shfl_sync(kAll, incl - __popc(w), j);
    if (k >= 0 && k < total) row = ((w0 + j) << 5) + nth_bit(wj, k - below);
    k -= total;
    w0 += 32;
    if (w0 >= nw || !__any_sync(kAll, k >= 0)) return row;
    w = w0 + lane < nw ? bits[w0 + lane] : 0u;
    incl = inclusive_count(w, lane);
  }
}

// One lane group's bid for row r (-1: the group has none this pass);
// every lane of the warp calls it. Returns 1 on the lane that bid.
__device__ __forceinline__ int group_bid(int r, const float* cost_s, int S,
                                         int C, const float* prices, int G,
                                         int gl, float eps,
                                         unsigned long long* col_bid,
                                         unsigned* drops) {
  float best = -INFINITY, second = kNeg;
  int best_c = C;
  if (r >= 0) {
    // 8 columns a step: their loads first, then the scan in registers
    const float* cr = cost_s + (size_t)r * S;
    for (int c0 = gl; c0 < C; c0 += 8 * G) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + j * G;
        v[j] = c < C ? -cr[c] - prices[c] : -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (v[j] > best) {  // strict: ties go to the lower column
          second = fmaxf(second, best);
          best = v[j];
          best_c = c0 + j * G;
        } else {
          second = fmaxf(second, v[j]);
        }
      }
    }
  }
  for (int off = G >> 1; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kAll, best, off);
    const float os = __shfl_xor_sync(kAll, second, off);
    const int oc = __shfl_xor_sync(kAll, best_c, off);
    const bool take = ob > best || (ob == best && oc < best_c);
    second = fmaxf(second, fmaxf(os, take ? best : ob));
    if (take) {
      best = ob;
      best_c = oc;
    }
  }
  if (r < 0 || gl != 0) return 0;
  if (!(best > -1e8f)) {
    atomicOr(&drops[r >> 5], 1u << (r & 31));  // for good (see the header)
    return 0;
  }
  const float v = (best - second) + eps;
  atomicMax(&col_bid[best_c],
            (static_cast<unsigned long long>(__float_as_uint(v)) << 32) |
                row_key(static_cast<unsigned>(r)));
  return 1;
}

__global__ void __launch_bounds__(kThreads, 1)
    auction_kernel(const float* __restrict__ cost,
                   const uint8_t* __restrict__ active, int R, int C, int S,
                   int num_iters, float eps0, int32_t* __restrict__ row_out,
                   int32_t* __restrict__ col_out,
                   int32_t* __restrict__ rounds_out) {
  extern __shared__ uint4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const Layout L(R, C, S);
  unsigned long long* col_bid = reinterpret_cast<unsigned long long*>(smem);
  float* cost_s = reinterpret_cast<float*>(smem + L.cost);
  float* prices = reinterpret_cast<float*>(smem + L.price);
  int* col_assign = reinterpret_cast<int*>(smem + L.col);
  unsigned* bidders = reinterpret_cast<unsigned*>(smem + L.bid);
  unsigned* drops = reinterpret_cast<unsigned*>(smem + L.drop);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int kWarps = kThreads / 32;
  const int nw = words(R);
  const size_t b = blockIdx.x;
  const float* cost_b = cost + b * (size_t)R * C;
  if (C % 4 == 0 && S % 4 == 0 &&
      reinterpret_cast<uintptr_t>(cost) % 16 == 0) {
    const int q = C / 4;  // 16-byte pieces a row
    const float4* src = reinterpret_cast<const float4*>(cost_b);
    for (int i = tid; i < R * q; i += kThreads) {
      const int r = i / q;
      reinterpret_cast<float4*>(cost_s + (size_t)r * S)[i - r * q] = src[i];
    }
  } else {
    for (int i = tid; i < R * C; i += kThreads) {
      const int r = i / C;
      cost_s[(size_t)r * S + (i - r * C)] = cost_b[i];
    }
  }
  for (int i = warp; i < nw; i += kWarps) {
    const int r = i * 32 + lane;
    const unsigned m = __ballot_sync(
        kAll, r < R && (active == nullptr || active[b * R + r] != 0));
    if (lane == 0) {
      bidders[i] = m;
      drops[i] = 0u;
    }
  }
  for (int c = tid; c < C; c += kThreads) {
    col_assign[c] = -1;
    prices[c] = 0.0f;
    col_bid[c] = 0ull;
  }
  __syncthreads();

  const int G = auction_group(C), gl = lane & (G - 1), grp = lane / G;
  const int per_warp = 32 / G, step = kWarps * per_warp;
  float eps = eps0;
  int it = 0;
  for (; it < num_iters; ++it) {
    // 1 the bidders' ranks: the first 32 words in the lanes, then n
    const unsigned w_first = lane < nw ? bidders[lane] : 0u;
    const int incl_first = inclusive_count(w_first, lane);
    int n = __shfl_sync(kAll, incl_first, 31);
    for (int i = 32; i < nw; i += 32) {
      int x = i + lane < nw ? __popc(bidders[i + lane]) : 0;
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_xor_sync(kAll, x, off);
      n += x;
    }

    // 2 their bids, per_warp rows a warp, a pass of the block: by rank
    // where fewer than half the rows bid, else every row in turn
    int bid = 0;
    if (2 * n < R) {
      for (int base = warp * per_warp; base < n; base += step)
        bid |= group_bid(
            nth_bidder(bidders, nw, w_first, incl_first, base + grp, lane),
            cost_s, S, C, prices, G, gl, eps, col_bid, drops);
    } else {
      for (int base = warp * per_warp; base < R; base += step) {
        int r = base + grp;
        if (r >= R || !(bidders[r >> 5] >> (r & 31) & 1u)) r = -1;
        if (__any_sync(kAll, r >= 0))  // else the warp's rows: none bid
          bid |= group_bid(r, cost_s, S, C, prices, G, gl, eps, col_bid,
                           drops);
      }
    }

    // 3 barrier and block-wide vote: a round without a bid changes nothing
    if (!__syncthreads_or(bid)) break;

    // 4 awarding: threads over columns; then this round's drops
    for (int c = tid; c < C; c += kThreads) {
      const unsigned long long key = col_bid[c];
      if (key != 0ull) {
        const int winner =
            static_cast<int>(row_key(static_cast<unsigned>(key)));
        const int old = col_assign[c];
        if (old >= 0) atomicOr(&bidders[old >> 5], 1u << (old & 31));
        atomicAnd(&bidders[winner >> 5], ~(1u << (winner & 31)));
        col_assign[c] = winner;
        prices[c] = prices[c] + __uint_as_float(
                                    static_cast<unsigned>(key >> 32));
        col_bid[c] = 0ull;
      }
    }
    for (int i = tid; i < nw; i += kThreads) {
      const unsigned d = drops[i];
      if (d != 0u) {
        atomicAnd(&bidders[i], ~d);
        drops[i] = 0u;
      }
    }
    __syncthreads();
    eps = eps * 0.9f;
  }
  if (rounds_out != nullptr && tid == 0) rounds_out[b] = it;
  for (int r = tid; r < R; r += kThreads) row_out[b * R + r] = -1;
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    const int r = col_assign[c];
    col_out[b * C + c] = r;
    if (r >= 0) row_out[b * R + r] = c;
  }
}

}  // namespace

extern "C" size_t posebyte_auction_smem_bytes(int R, int C) {
  return Layout(R, C, plan_stride(R, C)).total;
}

// cost [B, R, C] float32, active [B, R] uint8 (0/1) or null (every row
// active); row_out [B, R] and col_out [B, C] int32; rounds_out [B] int32
// or null: each matrix's rounds that awarded bids (num_iters where the
// budget ran out). Launches on `stream`; returns the launch status
// (cudaErrorInvalidValue where the shape does not fit kMaxSmem).
extern "C" cudaError_t posebyte_auction(const float* cost,
                                        const uint8_t* active,
                                        int32_t* row_out, int32_t* col_out,
                                        int B, int R, int C, int num_iters,
                                        float eps0, int32_t* rounds_out,
                                        void* stream) {
  if (B <= 0 || R <= 0 || C <= 0) return cudaErrorInvalidValue;
  const int S = plan_stride(R, C);
  const size_t smem = Layout(R, C, S).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  auction_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, active, R, C, S, num_iters, eps0, row_out, col_out, rounds_out);
  return cudaGetLastError();
}

extern "C" const char* posebyte_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

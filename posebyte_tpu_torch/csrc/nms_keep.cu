// Kernel 1: the pose-NMS keep mask over score-sorted candidates.
//
// Replaces posebyte_tpu/ops/pallas_kernels.py::nms_keep_pallas
// (_nms_kernel). For candidates j < k (rank order), j dominates k when
//   both are valid and  iou > iou_thr  or  (count >= 3 and (oks > oks_thr
//   or (oks > 0.4 and iou > 0.2))),
// with box IoU, and OKS over the 17 keypoints visible (conf > 0.2) on both
// sides: scale^2 = max(area_j, area_k, 32^2), per keypoint
// exp(-d^2 / (2 scale^2 4 sigma^2)), mean over the co-visible ones. The
// keep mask is exact greedy suppression in rank order:
//   keep[k] = valid[k] and no kept j < k dominates k,
// the semantics of the XLA path (posebyte_tpu/ops/nms.py:75-99). The TPU
// kernel's cap of 24 Jacobi sweeps is a Mosaic lowering limit, not part of
// the function; this kernel has no such cap.
//
// What bounds it on an H100: neither bytes nor arithmetic but latency. At
// the main path's N = 256 it reads 57 KB and writes 256 B and evaluates up
// to N(N-1)/2 = 32640 pairs of 17 keypoints, each with an IEEE division
// and an expf: a few microseconds of the card's float32 rate if spread
// over its SMs, but the greedy pass is a chain of N dependent decisions.
//
// Design (v2): two kernels on one stream, launched by posebyte_nms_keep.
//  1 dominance, one block per tile of 32 rows j x 32 candidates k on or
//    above the diagonal (W (W + 1) / 2 tiles per set, W = ceil(N / 32);
//    grid = (tiles, B)). A tile without a valid row returns at once, one
//    without a valid candidate writes zero words; the others copy their
//    rows' and candidates' poses and boxes into shared memory (the
//    candidates as planes, so that the lanes of a warp read consecutive
//    words). Each of the 8 warps takes 4 rows, one lane per k, and
//    __ballot_sync of "j dominates k" is word w of row j of the bitmask
//    [B, N, W] in device memory (the wrapper allocates it), written by
//    lane 0. No atomics; an invalid row's words are never read.
//  2 greedy pass, one warp per set (grid = B), for any N up to kMaxN: the
//    warp walks the set's bitmask 32 ranks at a time, from shared memory
//    where it fits (N <= 1350; copied there first), else from device
//    memory (L2 holds it: the dominance kernel has just written it). Lane
//    l holds words l, l + 32, ... of the suppressed set in registers. For
//    word v every lane holds row 32v + lane's bits of word v (the
//    dominance inside the word), gathers them by shuffles and decides the
//    word's 32 ranks in order from its suppressed bits (each kept rank ORs
//    in its row); then each lane ORs word w of every kept row of word v
//    into each suppressed word w > v it holds. A word without a valid rank
//    is skipped. No block barrier: the pass costs W words of 32 register
//    steps plus the ORs.
// Pairs whose IoU alone decides skip the OKS, and only co-visible
// keypoints are evaluated; both shortcuts give the same mask. The
// arithmetic keeps the JAX order: dx*dx + dy*dy with no contraction (built
// with -fmad=false), expf (not __expf) of -d^2 / ((2 scale^2) *
// (4 sigma^2)), IEEE division, keypoints summed in index order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNumKp = 17;
constexpr int kPoseStride = kNumKp * 3;
// The greedy pass holds the removed set in registers, at most 32 words a
// lane: W <= 1024 words, N <= 32768 candidates, 32 times the reference's
// cap of 1024. That is the kernel's one limit on N; at it one set's mask
// takes 128 MiB, a 128-frame chunk's 16 GiB of the card's 80.
constexpr int kMaxWordsPerLane = 32;
constexpr int kMaxN = 32 * 32 * kMaxWordsPerLane;
// The most dynamic shared memory a block may use on sm_90 (232,448 bytes),
// the only target the library is built for.
constexpr size_t kMaxSmem = 232448;
constexpr int kDomThreads = 256;          // 8 warps, 4 rows each
constexpr int kPlanes = kPoseStride + 4;  // 51 pose values + 4 box values

struct Sig4 {
  float v[kNumKp];  // 4 * sigma^2, float32, from the wrapper
};

__host__ __device__ inline int n_words(int N) { return (N + 31) / 32; }
// Where the greedy pass's copy of the mask starts in its shared memory:
// after the W valid words, on a 16-byte boundary.
__host__ __device__ inline int mask_offset(int W) { return (W + 3) & ~3; }

// Shared memory of a dominance block: its rows [32][kPlanes], its
// candidates [kPlanes][32], and their valid flags.
constexpr size_t kDomSmem = 64 * kPlanes * sizeof(float) + 64;

// Candidate n's value c of kPlanes (pose q * 3 + x/y/conf, then the box's
// x1, y1, x2, y2) from device memory; 0 past the end.
__device__ inline float cand(const float* P, const float* Bx, int N, int n,
                             int c) {
  if (n >= N) return 0.0f;
  return c < kPoseStride ? P[n * kPoseStride + c]
                         : Bx[n * 4 + c - kPoseStride];
}

__global__ void __launch_bounds__(kDomThreads)
    nms_dominance_kernel(const float* __restrict__ poses,
                         const float* __restrict__ boxes,
                         const uint8_t* __restrict__ valid,
                         uint32_t* __restrict__ mask, int N, float iou_thr,
                         float oks_thr, Sig4 sig4) {
  extern __shared__ float dsm[];
  const int W = n_words(N);
  int v = 0, t = blockIdx.x;     // tile t -> row word v, candidate word w
  while (t >= W - v) {
    t -= W - v;
    ++v;
  }
  const int w = v + t;
  float* rp = dsm;                           // [32][kPlanes]
  float* cp = dsm + 32 * kPlanes;            // [kPlanes][32]
  uint8_t* rv = reinterpret_cast<uint8_t*>(cp + kPlanes * 32);  // [32]
  uint8_t* cv = rv + 32;                                        // [32]
  const size_t b = blockIdx.y;
  const float* P = poses + b * N * kPoseStride;
  const float* Bx = boxes + b * N * 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = 32 * v, k0 = 32 * w;
  const bool row_ok = tid < 32 && j0 + tid < N && valid[b * N + j0 + tid];
  const bool col_ok = tid < 32 && k0 + tid < N && valid[b * N + k0 + tid];
  if (tid < 32) {
    rv[tid] = row_ok;
    cv[tid] = col_ok;
  }
  if (__syncthreads_count(row_ok) == 0) return;   // no row is ever read
  if (__syncthreads_count(col_ok) == 0) {         // all words zero
    if (tid < 32 && j0 + tid < N) mask[(b * N + j0 + tid) * W + w] = 0u;
    return;
  }
#pragma unroll 4
  for (int i = tid; i < 32 * kPlanes; i += kDomThreads) {
    const int r = i / kPlanes, c = i - r * kPlanes;
    rp[i] = cand(P, Bx, N, j0 + r, c);
    cp[c * 32 + r] = cand(P, Bx, N, k0 + r, c);
  }
  __syncthreads();

  const int k = k0 + lane;
  for (int rr = warp; rr < 32; rr += kDomThreads / 32) {
    const int j = j0 + rr;       // the same on every lane of the warp
    if (j >= N) break;
    const float* jr = rp + rr * kPlanes;
    bool over = false;
    if (rv[rr] && cv[lane] && k > j) {
      const float jx1 = jr[kPoseStride], jy1 = jr[kPoseStride + 1];
      const float jx2 = jr[kPoseStride + 2], jy2 = jr[kPoseStride + 3];
      const float kx1 = cp[kPoseStride * 32 + lane];
      const float ky1 = cp[(kPoseStride + 1) * 32 + lane];
      const float kx2 = cp[(kPoseStride + 2) * 32 + lane];
      const float ky2 = cp[(kPoseStride + 3) * 32 + lane];
      const float ix = fmaxf(0.0f, fminf(jx2, kx2) - fmaxf(jx1, kx1));
      const float iy = fmaxf(0.0f, fminf(jy2, ky2) - fmaxf(jy1, ky1));
      const float inter = ix * iy;
      const float area_j = (jx2 - jx1) * (jy2 - jy1);
      const float area_k = (kx2 - kx1) * (ky2 - ky1);
      const float uni = (area_j + area_k) - inter;
      const float iou = uni > 0.0f ? inter / fmaxf(uni, 1e-9f) : 0.0f;
      over = iou > iou_thr;
      if (!over) {
        const float scale2 =
            2.0f * fmaxf(fmaxf(area_j, area_k), 32.0f * 32.0f);
        float sum = 0.0f;
        int count = 0;
#pragma unroll
        for (int q = 0; q < kNumKp; ++q) {
          if (jr[3 * q + 2] > 0.2f && cp[(3 * q + 2) * 32 + lane] > 0.2f) {
            const float dx = jr[3 * q] - cp[3 * q * 32 + lane];
            const float dy = jr[3 * q + 1] - cp[(3 * q + 1) * 32 + lane];
            const float dist_sq = dx * dx + dy * dy;
            sum = sum + expf(-dist_sq / (scale2 * sig4.v[q]));
            count += 1;
          }
        }
        if (count >= 3) {
          const float oks = sum / static_cast<float>(count);
          over = oks > oks_thr || (oks > 0.4f && iou > 0.2f);
        }
      }
    }
    const uint32_t word = __ballot_sync(0xffffffffu, over);
    if (lane == 0) mask[(b * N + j) * W + w] = word;
  }
}

// The greedy pass over one set. Lane l holds words l, l + 32, ... of the
// removed set in registers: WPL of them (a power of two >= ceil(W / 32),
// a template argument so that every index into supp[] is static). Word v
// is always supp[0] of lane v % 32 while its 32 ranks are decided: after
// each 32 words the lanes shift their words down by one slot. The valid
// words sit in shared memory; the bitmask in shared memory too where the
// launcher chose so (smem_mask; it then copies it first), else the warp
// reads it from device memory, where the dominance kernel just wrote it
// and L2 still holds it.
template <int WPL>
__global__ void __launch_bounds__(32)
    nms_greedy_kernel(const uint8_t* __restrict__ valid,
                      const uint32_t* __restrict__ mask,
                      uint8_t* __restrict__ keep, int N, int smem_mask) {
  extern __shared__ uint32_t gsm[];
  const int W = n_words(N);
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x;
  uint32_t* vwords = gsm;                   // [W] valid words
  const uint32_t* m = mask + b * N * W;     // the set's mask [N][W]
  if (smem_mask) {
    uint32_t* ms = gsm + mask_offset(W);
    const size_t n = (size_t)N * W;
    if (n % 4 == 0) {                       // 16-byte pieces, 8 in flight
      const uint4* m4 = reinterpret_cast<const uint4*>(m);
      uint4* s4 = reinterpret_cast<uint4*>(ms);
#pragma unroll 8
      for (size_t i = lane; i < n / 4; i += 32) s4[i] = m4[i];
    } else {
#pragma unroll 8
      for (size_t i = lane; i < n; i += 32) ms[i] = m[i];
    }
    m = ms;
  }
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    const int k = 32 * w + lane;
    const uint32_t v =
        __ballot_sync(0xffffffffu, k < N && valid[b * N + k] != 0);
    if (lane == 0) vwords[w] = v;
  }
  __syncwarp();
  uint32_t supp[WPL];
#pragma unroll
  for (int j = 0; j < WPL; ++j) supp[j] = 0u;
  for (int v0 = 0; v0 < W; v0 += 32) {      // supp[j]: word v0 + 32 j + lane
    for (int l = 0; l < 32 && v0 + l < W; ++l) {
      const int v = v0 + l;
      const uint32_t live = vwords[v];
      if (live == 0u) continue;             // no valid rank in word v
      const int i = 32 * v + lane;
      const uint32_t inner = i < N ? m[(size_t)i * W + v] : 0u;
      uint32_t s = __shfl_sync(0xffffffffu, supp[0], l);
      uint32_t kept = 0u;
#pragma unroll
      for (int r = 0; r < 32; ++r) {        // the same on every lane
        const uint32_t row = __shfl_sync(0xffffffffu, inner, r);
        if ((live & ~s) >> r & 1u) {        // valid and not suppressed
          kept |= 1u << r;
          s |= row;
        }
      }
      if (lane == l) supp[0] = s;
      // every later word w this lane holds ORs in the kept rows' word w
#pragma unroll
      for (int j = 0; j < WPL; ++j) {
        const int w = v0 + 32 * j + lane;
        if (w > v && w < W) {
          for (uint32_t rest = kept; rest != 0u; rest &= rest - 1u)
            supp[j] |= m[(size_t)(32 * v + __ffs(rest) - 1) * W + w];
        }
      }
    }
    // words v0 .. v0 + 31 are decided: write their keep bits, shift
    const int k0 = 32 * v0;
    for (int l = 0; l < 32 && v0 + l < W; ++l) {
      const uint32_t s = __shfl_sync(0xffffffffu, supp[0], l);
      const int k = k0 + 32 * l + lane;
      if (k < N) keep[b * N + k] = ((vwords[v0 + l] & ~s) >> lane) & 1u;
    }
#pragma unroll
    for (int j = 0; j + 1 < WPL; ++j) supp[j] = supp[j + 1];
  }
}

// The greedy pass with WPL register words a lane. Its mask is read from
// shared memory where the valid words and the whole mask fit there (N <=
// 1350), else from device memory: a route chosen by size.
template <int WPL>
cudaError_t launch_greedy(const uint8_t* valid, const uint32_t* mask,
                          uint8_t* keep, int B, int N, cudaStream_t st) {
  const int W = n_words(N);
  const size_t words = (size_t)mask_offset(W) + (size_t)N * W;
  const int smem_mask = words * sizeof(uint32_t) <= kMaxSmem;
  const size_t smem = (smem_mask ? words : W) * sizeof(uint32_t);
  auto kernel = nms_greedy_kernel<WPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, 32, smem, st>>>(valid, mask, keep, N, smem_mask);
  return cudaGetLastError();
}

}  // namespace

extern "C" cudaError_t posebyte_nms_keep(const float* poses,
                                         const float* boxes,
                                         const uint8_t* valid,
                                         uint32_t* mask, uint8_t* keep,
                                         int B, int N, float iou_thr,
                                         float oks_thr,
                                         const float* sig4_host,
                                         void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || N > kMaxN)
    return cudaErrorInvalidValue;
  Sig4 sig4;
  for (int q = 0; q < kNumKp; ++q) sig4.v[q] = sig4_host[q];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_words(N) * (n_words(N) + 1) / 2, B);
  nms_dominance_kernel<<<grid, kDomThreads, kDomSmem, st>>>(
      poses, boxes, valid, mask, N, iou_thr, oks_thr, sig4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int wpl = (n_words(N) + 31) / 32;
  if (wpl <= 1) return launch_greedy<1>(valid, mask, keep, B, N, st);
  if (wpl <= 2) return launch_greedy<2>(valid, mask, keep, B, N, st);
  if (wpl <= 4) return launch_greedy<4>(valid, mask, keep, B, N, st);
  if (wpl <= 8) return launch_greedy<8>(valid, mask, keep, B, N, st);
  if (wpl <= 16) return launch_greedy<16>(valid, mask, keep, B, N, st);
  return launch_greedy<kMaxWordsPerLane>(valid, mask, keep, B, N, st);
}

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
//  2 greedy pass, one warp per set (grid = B): the warp copies the set's
//    bitmask into shared memory and walks it 32 ranks at a time. For word
//    v every lane holds row 32v + lane's bits of word v (the dominance
//    inside the word), gathers them by shuffles and decides the word's 32
//    ranks in order from its suppressed bits (each kept rank ORs in its
//    row); then lane w > v ORs word w of every kept row of word v into the
//    suppressed word w it holds. A word without a valid rank is skipped.
//    No block barrier: the pass costs W words of 32 register steps plus
//    the ORs.
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
constexpr int kMaxN = 512;
constexpr int kDomThreads = 256;          // 8 warps, 4 rows each
constexpr int kPlanes = kPoseStride + 4;  // 51 pose values + 4 box values

struct Sig4 {
  float v[kNumKp];  // 4 * sigma^2, float32, from the wrapper
};

__host__ __device__ inline int n_words(int N) { return (N + 31) / 32; }

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

__global__ void __launch_bounds__(32)
    nms_greedy_kernel(const uint8_t* __restrict__ valid,
                      const uint32_t* __restrict__ mask,
                      uint8_t* __restrict__ keep, int N) {
  extern __shared__ uint32_t gsm[];         // the set's mask [N][W]
  const int W = n_words(N);
  const size_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint32_t* m = mask + b * N * W;
  if ((N * W) % 4 == 0) {                   // 16-byte pieces, 8 in flight
    const uint4* m4 = reinterpret_cast<const uint4*>(m);
    uint4* g4 = reinterpret_cast<uint4*>(gsm);
#pragma unroll 8
    for (int i = lane; i < N * W / 4; i += 32) g4[i] = m4[i];
  } else {
#pragma unroll 8
    for (int i = lane; i < N * W; i += 32) gsm[i] = m[i];
  }
  // lane w < W holds valid word w and the suppressed word w
  uint32_t vword = 0u, supp = 0u;
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    const int k = 32 * w + lane;
    const uint32_t v =
        __ballot_sync(0xffffffffu, k < N && valid[b * N + k] != 0);
    if (lane == w) vword = v;
  }
  __syncwarp();
  for (int v = 0; v < W; ++v) {
    const uint32_t live = __shfl_sync(0xffffffffu, vword, v);
    if (live == 0u) continue;               // no valid rank in word v
    const int i = 32 * v + lane;
    const uint32_t inner = i < N ? gsm[i * W + v] : 0u;
    uint32_t s = __shfl_sync(0xffffffffu, supp, v);
    uint32_t kept = 0u;
#pragma unroll
    for (int r = 0; r < 32; ++r) {          // the same on every lane
      const uint32_t row = __shfl_sync(0xffffffffu, inner, r);
      if ((live & ~s) >> r & 1u) {          // valid and not suppressed
        kept |= 1u << r;
        s |= row;
      }
    }
    if (lane == v) supp = s;
    if (lane > v && lane < W) {
      for (uint32_t rest = kept; rest != 0u; rest &= rest - 1u)
        supp |= gsm[(32 * v + __ffs(rest) - 1) * W + lane];
    }
  }
  for (int w = 0; w < W; ++w) {
    const uint32_t s = __shfl_sync(0xffffffffu, supp, w);
    const uint32_t live = __shfl_sync(0xffffffffu, vword, w);
    const int k = 32 * w + lane;
    if (k < N) keep[b * N + k] = ((live & ~s) >> lane) & 1u;
  }
}

}  // namespace

extern "C" int posebyte_nms_keep_max_n() { return kMaxN; }

// poses [B, N, 17, 3] f32, boxes [B, N, 4] f32, valid [B, N] u8 (0/1),
// mask [B, N, ceil(N / 32)] u32 scratch, sig4_host: 17 floats (4 sigma^2)
// in host memory; keep [B, N] u8 (0/1). Launches the dominance kernel and
// then the greedy pass on `stream`; returns the first launch status that
// is not cudaSuccess.
extern "C" cudaError_t posebyte_nms_keep(const float* poses,
                                         const float* boxes,
                                         const uint8_t* valid,
                                         uint32_t* mask, uint8_t* keep,
                                         int B, int N, float iou_thr,
                                         float oks_thr,
                                         const float* sig4_host,
                                         void* stream) {
  if (B <= 0 || N <= 0 || N > kMaxN) return cudaErrorInvalidValue;
  Sig4 sig4;
  for (int q = 0; q < kNumKp; ++q) sig4.v[q] = sig4_host[q];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_words(N) * (n_words(N) + 1) / 2, B);
  nms_dominance_kernel<<<grid, kDomThreads, kDomSmem, st>>>(
      poses, boxes, valid, mask, N, iou_thr, oks_thr, sig4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t gsmem = (size_t)N * n_words(N) * sizeof(uint32_t);
  nms_greedy_kernel<<<B, 32, gsmem, st>>>(valid, mask, keep, N);
  return cudaGetLastError();
}

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
// What bounds it on an H100: arithmetic, not bytes. At the main path's
// N = 256 it reads 57 KB and writes 256 B, but it evaluates up to
// N(N-1)/2 = 32640 pairs of 17 keypoints, each with an IEEE division and an
// expf, on one SM; the greedy pass then takes one barrier per kept
// candidate.
//
// Design: one block of 512 threads per candidate set (grid = batch, so a
// later slice can run K frames in one launch). Thread t owns column
// k = t % Np, keeps candidate k's 55 floats in registers and walks the rows
// j = t / Np, t / Np + 512 / Np, ... < k, reading row j from the L1 cache
// (all lanes of a warp read the same j: one broadcast load). Pairs whose
// IoU alone decides skip the OKS, and only co-visible keypoints are
// evaluated; both shortcuts give the same mask. Dominance bits go to a
// shared-memory bitmask laid out [word of j][k], so lanes hit consecutive
// banks (8 KB at N = 256). The greedy pass walks the ranks; at each kept
// candidate every thread reaches the same barrier (block-uniform). The
// arithmetic keeps the JAX order: dx*dx + dy*dy with no contraction
// (built with -fmad=false), expf (not __expf) of -d^2 / ((2 scale^2) *
// (4 sigma^2)), IEEE division, keypoints summed in index order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNumKp = 17;
constexpr int kPoseStride = kNumKp * 3;
constexpr int kThreads = 512;

struct Sig4 {
  float v[kNumKp];  // 4 * sigma^2, float32, from the wrapper
};

__global__ void __launch_bounds__(kThreads)
    nms_keep_kernel(const float* __restrict__ poses,
                    const float* __restrict__ boxes,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int N, float iou_thr,
                    float oks_thr, Sig4 sig4) {
  extern __shared__ uint32_t smem[];
  const int W = (N + 31) / 32;
  uint32_t* dom = smem;                                   // [W][N]
  uint8_t* supp = reinterpret_cast<uint8_t*>(dom + (size_t)W * N);  // [N]
  uint8_t* val = supp + N;                                // [N]

  const size_t b = blockIdx.x;
  const float* P = poses + b * (size_t)N * kPoseStride;
  const float* Bx = boxes + b * (size_t)N * 4;
  const int tid = threadIdx.x;

  for (int i = tid; i < W * N; i += blockDim.x) dom[i] = 0u;
  for (int i = tid; i < N; i += blockDim.x) {
    supp[i] = 0;
    val[i] = valid[b * N + i] ? 1 : 0;
  }
  __syncthreads();

  // ---- dominance bitmask ------------------------------------------------
  const int Np = W * 32;
  const int nphase = blockDim.x / Np;
  const int k = tid % Np;
  const int phase = tid / Np;
  if (phase < nphase && k < N && val[k]) {
    float kx[kNumKp], ky[kNumKp], kc[kNumKp];
#pragma unroll
    for (int q = 0; q < kNumKp; ++q) {
      kx[q] = P[k * kPoseStride + q * 3 + 0];
      ky[q] = P[k * kPoseStride + q * 3 + 1];
      kc[q] = P[k * kPoseStride + q * 3 + 2];
    }
    const float kx1 = Bx[k * 4 + 0], ky1 = Bx[k * 4 + 1];
    const float kx2 = Bx[k * 4 + 2], ky2 = Bx[k * 4 + 3];
    const float area_k = (kx2 - kx1) * (ky2 - ky1);

    for (int j = phase; j < k; j += nphase) {
      if (!val[j]) continue;
      const float* pj = P + (size_t)j * kPoseStride;
      const float jx1 = __ldg(Bx + j * 4 + 0), jy1 = __ldg(Bx + j * 4 + 1);
      const float jx2 = __ldg(Bx + j * 4 + 2), jy2 = __ldg(Bx + j * 4 + 3);
      const float ix = fmaxf(0.0f, fminf(jx2, kx2) - fmaxf(jx1, kx1));
      const float iy = fmaxf(0.0f, fminf(jy2, ky2) - fmaxf(jy1, ky1));
      const float inter = ix * iy;
      const float area_j = (jx2 - jx1) * (jy2 - jy1);
      const float uni = (area_j + area_k) - inter;
      const float iou = uni > 0.0f ? inter / fmaxf(uni, 1e-9f) : 0.0f;

      bool over = iou > iou_thr;
      if (!over) {
        const float scale2 =
            2.0f * fmaxf(fmaxf(area_j, area_k), 32.0f * 32.0f);
        float sum = 0.0f;
        int count = 0;
#pragma unroll
        for (int q = 0; q < kNumKp; ++q) {
          if (__ldg(pj + q * 3 + 2) > 0.2f && kc[q] > 0.2f) {
            const float dx = __ldg(pj + q * 3 + 0) - kx[q];
            const float dy = __ldg(pj + q * 3 + 1) - ky[q];
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
      if (over) atomicOr(&dom[(j >> 5) * N + k], 1u << (j & 31));
    }
  }
  __syncthreads();

  // ---- exact greedy suppression in rank order ----------------------------
  // At step i the flags val[i] and supp[i] are final, and no thread writes
  // them during the step (writes go to supp[t], t > i), so every thread
  // reads the same values and takes the branch, and its barrier, alike.
  // A step whose candidate is not kept writes nothing and needs no
  // barrier, so the pass costs one barrier per kept candidate.
  for (int i = 0; i < N; ++i) {
    if (val[i] && !supp[i]) {
      for (int t = tid; t < N; t += blockDim.x)
        if (t > i && ((dom[(i >> 5) * N + t] >> (i & 31)) & 1u)) supp[t] = 1;
      __syncthreads();
    }
  }

  for (int t = tid; t < N; t += blockDim.x)
    keep[b * N + t] = (val[t] && !supp[t]) ? 1 : 0;
}

}  // namespace

extern "C" int posebyte_nms_keep_max_n() { return kThreads; }

// poses [B, N, 17, 3] f32, boxes [B, N, 4] f32, valid [B, N] u8 (0/1),
// sig4_host: 17 floats (4 sigma^2) in host memory; keep [B, N] u8 (0/1).
// Launches on `stream`; returns the launch status.
extern "C" cudaError_t posebyte_nms_keep(const float* poses,
                                         const float* boxes,
                                         const uint8_t* valid, uint8_t* keep,
                                         int B, int N, float iou_thr,
                                         float oks_thr,
                                         const float* sig4_host,
                                         void* stream) {
  if (B <= 0 || N <= 0 || N > kThreads) return cudaErrorInvalidValue;
  Sig4 sig4;
  for (int q = 0; q < kNumKp; ++q) sig4.v[q] = sig4_host[q];
  const int W = (N + 31) / 32;
  const size_t smem = (size_t)W * N * sizeof(uint32_t) + 2 * (size_t)N;
  nms_keep_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      poses, boxes, valid, keep, N, iou_thr, oks_thr, sig4);
  return cudaGetLastError();
}

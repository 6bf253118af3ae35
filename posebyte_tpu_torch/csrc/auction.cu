// Kernel 2: the auction of one tracker association tier.
//
// Replaces posebyte_tpu/ops/pallas_kernels.py::auction_assign_pallas
// (_auction_kernel + auction_rounds): a Jacobi auction over the [R, C]
// track x detection cost matrix, all rounds in one launch.
//
// What bounds it on an H100: neither bytes nor arithmetic. At the tracker's
// shape (R = 128 tracks, C = 64 detections) it reads 33 KB and writes
// 0.8 KB, and a round is ~8 R C operations; the rounds are sequential and
// each ends at a block barrier, so the time is launch latency plus a few
// microseconds of barrier-separated rounds on one SM.
//
// Design: one block per cost matrix (grid = batch, so a later slice can
// solve many matrices in one launch). The matrix is copied once into shared
// memory, row-major, so that the lanes computing one row's bid read
// consecutive banks; assignments, prices and bids stay in shared memory
// for all rounds, and device memory is touched once each way. Each row's
// bid is computed by a group of auction_group(C) lanes (8 at C = 64), each
// scanning every G-th column, merged by shuffles (auction.cuh); the block
// has R x G threads (at most 1024), so every row of a round bids at once.
// Each column's highest bid (lowest row on ties, the JAX argmax's rule)
// is one 64-bit shared-memory atomicMax per bidder, so awarding costs O(1)
// per column instead of a scan over the rows, and a round has two barriers.
// The round loop's exit is block-uniform (auction.cuh). The kernel
// allocates nothing: the wrapper hands it the outputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "auction.cuh"

namespace {

__global__ void __launch_bounds__(1024)
    auction_kernel(const float* __restrict__ cost,
                   const uint8_t* __restrict__ active, int R, int C,
                   int num_iters, float eps0, int32_t* __restrict__ row_out,
                   int32_t* __restrict__ col_out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* col_bid = smem;                       // [C]
  float* cost_s = reinterpret_cast<float*>(col_bid + C);    // [R][C]
  float* prices = cost_s + (size_t)R * C;                   // [C]
  int* row_assign = reinterpret_cast<int*>(prices + C);     // [R]
  int* col_assign = row_assign + R;                         // [C]
  uint8_t* act = reinterpret_cast<uint8_t*>(col_assign + C);  // [R]

  const size_t b = blockIdx.x;
  const float* cost_b = cost + b * (size_t)R * C;
  for (int i = threadIdx.x; i < R * C; i += blockDim.x)
    cost_s[i] = cost_b[i];
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    act[r] = active[b * R + r];
  __syncthreads();

  posebyte::auction_rounds(cost_s, act, R, C, num_iters, eps0, row_assign,
                           col_assign, prices, col_bid);

  for (int r = threadIdx.x; r < R; r += blockDim.x)
    row_out[b * R + r] = row_assign[r];
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    col_out[b * C + c] = col_assign[c];
}

}  // namespace

extern "C" size_t posebyte_auction_smem_bytes(int R, int C) {
  return (size_t)C * sizeof(unsigned long long) +
         ((size_t)R * C + C) * sizeof(float) + (size_t)(R + C) * sizeof(int) +
         (size_t)R;
}

// cost [B, R, C] float32, active [B, R] uint8 (0/1); row_out [B, R] and
// col_out [B, C] int32. Launches on `stream`; returns the launch status.
extern "C" cudaError_t posebyte_auction(const float* cost,
                                        const uint8_t* active,
                                        int32_t* row_out, int32_t* col_out,
                                        int B, int R, int C, int num_iters,
                                        float eps0, void* stream) {
  if (B <= 0 || R <= 0 || C <= 0) return cudaErrorInvalidValue;
  const size_t smem = posebyte_auction_smem_bytes(R, C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  int threads = R * posebyte::auction_group(C);
  if (threads < C) threads = C;
  threads = ((threads + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  auction_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      cost, active, R, C, num_iters, eps0, row_out, col_out);
  return cudaGetLastError();
}

extern "C" const char* posebyte_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

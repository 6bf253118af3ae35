// Runs the port's CUDA kernels on the CPU, for tests on a host without a
// card: one std::thread per CUDA thread, a std::barrier per block for
// __syncthreads, blocks one after another, shared memory in one static
// buffer. tests/test_torch_kernel_emulation.py compiles the kernel sources
// with this header (after rewriting the launch syntax and the extern
// __shared__ declarations) and holds them against their plain PyTorch
// versions. Float arithmetic follows the card's where the kernels pin it
// (compile with -ffp-contract=off, as nvcc's -fmad=false); expf comes from
// the host's libm, so only the kernels' control flow and exact integer
// and comparison logic are what this checks. A barrier that not every
// thread reaches hangs here as it would on the card.
#pragma once

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};
inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 blockDim;
inline std::barrier<>* g_block_barrier = nullptr;
inline std::atomic<int> g_block_or{0};
alignas(16) inline unsigned char g_smem[256 * 1024];
inline size_t g_smem_limit = 48 * 1024;
inline int g_last_error = 0;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__ __restrict
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorLaunchOutOfResources = 701 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int bytes) {
  g_smem_limit = static_cast<size_t>(bytes);
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() {
  const int e = g_last_error;
  g_last_error = 0;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "emulated launch failure" : "no error";
}

inline void __syncthreads() { g_block_barrier->arrive_and_wait(); }
inline int __syncthreads_or(int pred) {
  if (pred) g_block_or.store(1);
  g_block_barrier->arrive_and_wait();
  const int r = g_block_or.load();
  g_block_barrier->arrive_and_wait();
  if (threadIdx.x == 0) g_block_or.store(0);
  g_block_barrier->arrive_and_wait();
  return r;
}
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
struct alignas(16) int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
// Four signed byte products of a and b summed into c (the card's dp4a).
inline int __dp4a(int a, int b, int c) {
  for (int i = 0; i < 4; ++i)
    c += static_cast<int8_t>(static_cast<unsigned>(a) >> (8 * i)) *
         static_cast<int8_t>(static_cast<unsigned>(b) >> (8 * i));
  return c;
}
template <class T>
inline T __ldg(const T* p) { return *p; }
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  unsigned long long cur = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (cur < v && !__atomic_compare_exchange_n(p, &cur, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return cur;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// emu_launch(grid, threads, smem, [&] { kernel(args); }).
inline void emu_launch(int grid, int threads, size_t smem,
                       const std::function<void()>& body) {
  if (threads > 1024 || smem > g_smem_limit || smem > sizeof(g_smem)) {
    g_last_error = cudaErrorLaunchOutOfResources;
    return;
  }
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b) {
    std::memset(g_smem, 0xAB, sizeof(g_smem));  // shared memory is garbage
    std::barrier<> bar(threads);
    g_block_barrier = &bar;
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& th : pool) th.join();
  }
}

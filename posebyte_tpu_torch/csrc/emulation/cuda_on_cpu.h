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
//
// The warp-collective PTX a kernel wraps in small device functions
// (ldmatrix_x4, mma_s8_16832) and the warp intrinsics (__ballot_sync,
// __any_sync, __shfl_sync, __shfl_xor_sync, __shfl_up_sync, __syncwarp) are
// supplied here with a barrier per warp
// and exchange buffers, the fragment layouts those of the PTX ISA; the
// warp must be converged at each, as the full mask asks on the card.
// clock64 is the host's monotone clock in nanoseconds. cp.async
// (cp_async_16, cp_async_commit, cp_async_wait) is deferred: a copy lands
// when a wait_group covers its group, so a kernel that reads a stage it
// has not waited for reads stale shared memory here as it may on the card.
// A kernel source leaves out its own PTX versions when
// POSEBYTE_CUDA_EMULATION is defined.
#pragma once

#define POSEBYTE_CUDA_EMULATION 1

#include <algorithm>
#include <atomic>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 blockDim;
inline std::barrier<>* g_block_barrier = nullptr;
inline std::atomic<int> g_block_or{0};
inline std::atomic<int> g_block_count{0};
// One per warp of the running block: its barrier and two exchange
// buffers, used in turns by successive collectives (a lane writes one
// only after the barrier of the collective in between, which every lane
// reaches after it has read it), so one barrier per collective suffices.
struct EmuWarp {
  std::unique_ptr<std::barrier<>> bar;
  const void* addr[2][32];
  unsigned v[2][32];
  unsigned a[2][32][4];
  unsigned b[2][32][2];
};
inline thread_local int t_xbuf = 0;  // the exchange buffer of the next one
inline std::vector<EmuWarp>* g_warps = nullptr;
alignas(16) inline unsigned char g_smem[256 * 1024];
inline size_t g_smem_limit = 48 * 1024;
inline int g_last_error = 0;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
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
inline int __syncthreads_count(int pred) {
  if (pred) g_block_count.fetch_add(1);
  g_block_barrier->arrive_and_wait();
  const int r = g_block_count.load();
  g_block_barrier->arrive_and_wait();
  if (threadIdx.x == 0) g_block_count.store(0);
  g_block_barrier->arrive_and_wait();
  return r;
}
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs(static_cast<int>(v)); }
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
struct alignas(8) int2 {
  int x, y;
};
inline int2 make_int2(int x, int y) { return int2{x, y}; }
struct alignas(8) uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
// IEEE division, round to nearest (the card's __fdiv_rn).
inline float __fdiv_rn(float a, float b) { return a / b; }
template <class T>
inline T __ldg(const T* p) { return *p; }
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicAnd(unsigned* p, unsigned v) {
  return __atomic_fetch_and(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
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

// cp.async: queued per thread, performed by the wait_group that covers
// its group; src_bytes < 16 fills the rest with zeros.
struct EmuCopy {
  void* dst;
  const void* src;
  int bytes, group;
};
inline thread_local std::vector<EmuCopy> t_copies;
inline thread_local int t_groups = 0;
inline void cp_async_16(void* dst, const void* src, int src_bytes) {
  t_copies.push_back(EmuCopy{dst, src, src_bytes, t_groups});
}
inline void cp_async_commit() { ++t_groups; }
template <int N>
inline void cp_async_wait() {
  size_t keep = 0;
  for (const EmuCopy& c : t_copies) {
    if (c.group < t_groups - N) {
      std::memset(c.dst, 0, 16);
      std::memcpy(c.dst, c.src, static_cast<size_t>(c.bytes));
    } else {
      t_copies[keep++] = c;
    }
  }
  t_copies.resize(keep);
}

inline EmuWarp& emu_warp() { return (*g_warps)[threadIdx.x >> 5]; }
// One 32-bit word from every lane of the warp (the exchange of the
// intrinsics below); lanes past a partial warp's end read 0.
inline const unsigned* emu_exchange(unsigned word) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31, x = t_xbuf;
  t_xbuf ^= 1;
  w.v[x][lane] = word;
  w.bar->arrive_and_wait();
  return w.v[x];
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp().bar->arrive_and_wait();
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
  const int n = std::min<int>(32, blockDim.x - (threadIdx.x & ~31u));
  const unsigned* v = emu_exchange(pred ? 1u : 0u);
  unsigned r = 0;
  for (int l = 0; l < n; ++l) r |= v[l] << l;
  return r & mask;
}
inline int __any_sync(unsigned mask, int pred) {
  return __ballot_sync(mask, pred) != 0u;
}
template <class T>
inline T __shfl_sync(unsigned, T var, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  unsigned u;
  std::memcpy(&u, &var, 4);
  const unsigned* v = emu_exchange(u);
  T r;
  std::memcpy(&r, &v[src & 31], 4);
  return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned mask, T var, int lane_mask) {
  return __shfl_sync(mask, var, static_cast<int>(threadIdx.x & 31) ^
                                    lane_mask);
}
template <class T>
inline T __shfl_up_sync(unsigned mask, T var, unsigned delta) {
  const int lane = static_cast<int>(threadIdx.x & 31);
  const T up = __shfl_sync(mask, var, lane - static_cast<int>(delta));
  return lane >= static_cast<int>(delta) ? up : var;
}
// ldmatrix.sync.aligned.m8n8.x4.shared.b16: lane l gives the address of
// row l % 8 of matrix l / 8 and gets bytes 4 (l % 4) .. + 3 of row l / 4
// of matrix j in r[j].
inline void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31, x = t_xbuf;
  t_xbuf ^= 1;
  w.addr[x][lane] = p;
  w.bar->arrive_and_wait();
  for (int j = 0; j < 4; ++j)
    std::memcpy(&r[j],
                static_cast<const unsigned char*>(
                    w.addr[x][8 * j + lane / 4]) + 4 * (lane % 4),
                4);
}
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, d += a * b. Fragments
// (g = lane / 4, t = lane % 4): a[0] A[g][4t .. 4t + 3], a[1] A[g + 8][..],
// a[2] A[g][16 + 4t ..], a[3] A[g + 8][16 + 4t ..]; b0 B[4t ..][g],
// b1 B[16 + 4t ..][g]; d[0], d[1] C[g][2t], C[g][2t + 1], d[2], d[3] the
// same of row g + 8.
inline void mma_s8_16832(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                         unsigned b1) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x & 31, x = t_xbuf;
  t_xbuf ^= 1;
  std::memcpy(w.a[x][lane], a, sizeof(w.a[x][lane]));
  w.b[x][lane][0] = b0;
  w.b[x][lane][1] = b1;
  w.bar->arrive_and_wait();
  auto byte = [](unsigned v, int k) {
    return static_cast<int>(static_cast<int8_t>(v >> (8 * (k % 4))));
  };
  const int g = lane / 4, t = lane % 4;
  for (int o = 0; o < 4; ++o) {
    const int row = g + 8 * (o / 2), col = 2 * t + o % 2;
    int sum = d[o];
    for (int k = 0; k < 32; ++k) {
      const int av = byte(w.a[x][(row % 8) * 4 + (k % 16) / 4]
                             [(row / 8) + 2 * (k / 16)], k);
      const int bv = byte(w.b[x][col * 4 + (k % 16) / 4][k / 16], k);
      sum += av * bv;
    }
    d[o] = sum;
  }
}

// kernel<<<grid, threads, smem, stream>>>(args) becomes
// emu_launch(grid, threads, smem, [&] { kernel(args); }). One thread per
// CUDA thread of a block runs the blocks one after another (x fastest,
// then y, then z), with a barrier between blocks; shared memory is filled
// with garbage before each block, and a thread's pending cp.async copies
// do not outlive its block.
inline void emu_launch(dim3 grid, int threads, size_t smem,
                       const std::function<void()>& body) {
  if (threads > 1024 || smem > g_smem_limit || smem > sizeof(g_smem)) {
    g_last_error = cudaErrorLaunchOutOfResources;
    return;
  }
  blockDim.x = threads;
  const unsigned nblocks = grid.x * grid.y * grid.z;
  std::barrier<> bar(threads);
  g_block_barrier = &bar;
  std::vector<EmuWarp> warps((threads + 31) / 32);
  for (size_t w = 0; w < warps.size(); ++w)
    warps[w].bar = std::make_unique<std::barrier<>>(
        std::min(32, threads - static_cast<int>(32 * w)));
  g_warps = &warps;
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      threadIdx.x = t;
      for (unsigned b = 0; b < nblocks; ++b) {
        if (t == 0) std::memset(g_smem, 0xAB, sizeof(g_smem));
        bar.arrive_and_wait();  // shared memory is garbage
        blockIdx.x = b % grid.x;
        blockIdx.y = b / grid.x % grid.y;
        blockIdx.z = b / (grid.x * grid.y);
        t_copies.clear();
        t_groups = 0;
        t_xbuf = 0;
        body();
        bar.arrive_and_wait();  // the block has ended on every thread
      }
    });
  for (auto& th : pool) th.join();
}

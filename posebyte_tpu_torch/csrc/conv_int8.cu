// Kernel 4: the w8a8 convolution as an implicit GEMM on the s8 tensor
// cores, int32 accumulation, the per-output-channel dequantisation fused as
// its epilogue and, in its float mode, the activation quantisation fused
// into its load.
//
// Replaces posebyte_tpu/ops/pallas_conv.py::conv3x3_int8_pallas
// (_conv3x3_kernel): a 3x3, same-padding, stride-1 convolution of int8 NHWC
// activations with int8 weights, summed in int32, then
//   out = bf16(float(acc) * scale[o])            (scale = s_x * s_w[o])
// The same source carries the JAX package's other w8a8 convolutions
// (posebyte_tpu/models/layers.py::conv2d, its act_scale branch: 3x3 stride 2
// and 1x1, with a bias): out = round(float(acc) * scale[o] + bias[o]) in the
// activation type, and that branch's quantisation,
//   q = clamp(rint(x / s_x), -127, 127)          (round half to even)
// The shapes are template parameters (KS, STRIDE) in {(3, 1), (3, 2),
// (1, 1)}; the input mode is one too:
//   int8   x int8 NHWC with Cp channels, already quantised (the Pallas
//          kernel's contract);
//   float  x bf16 or float32 NHWC as the model holds it, given by base
//          pointer, pixel stride and channel count C (channel stride 1), so
//          a channel slice of a wider tensor goes in without a copy. The
//          load divides by s_x (__fdiv_rn, not a multiply by the
//          reciprocal, which moves ties) and rounds with rintf.
//
// As a GEMM: M = B * Ho * Wo output pixels, N = O output channels,
// K = KS * KS * Cp reduction bytes, Cp = C padded to a multiple of 32
// (zeros). Weights are packed once as [Op][KS * KS][Cp] int8 (Op = O padded
// to a multiple of 64 with zero rows): both operands are K-major, as
// mma.sync ... row.col wants them.
//
// What bounds it on an H100: the card moves 3.35 TB/s and does 1,979 int8
// TOP/s. Over the 59 convolutions of a chunk of 128 frames (975 GOP) the
// int8 mode must move 3.80 GB (1.13 ms), the float mode, reading bf16,
// 5.42 GB (1.62 ms); the operations take 0.49 ms. Bytes bound both.
//
// Design. A block computes a BM x 64 output tile (BM = 128, 64 or 32,
// picked by the wrapper so that small batches still fill the 132 SMs) with
// 2 * BM threads: warps of 32 x 32, each a 2 x 4 grid of
// mma.sync.m16n8k32.s8 products whose operands come from shared memory by
// ldmatrix.x4. The reduction walks ring stages of 64 bytes (two steps of
// one tap and 32 channels each). A 4-stage ring in shared memory is
// filled by 16-byte cp.async copies (commit_group / wait_group, one
// barrier per stage); the halo, the pixels past M and the steps past K
// come in as zeros through a source size of 0. Tile rows are 64 bytes, and
// each 16-byte chunk's index is XORed with (row / 2) % 4, so that the
// copies and the ldmatrix reads of 8 rows touch 8 distinct bank groups.
// In the float mode the weights still come by cp.async, and the A tile
// passes through registers: the loads of stage s + 2 are issued before
// the products of stage s, and quantised and stored to the ring during
// stage s + 1. Quantising in the load costs ALU work per element loaded
// (a division, a rounding, a conversion), and a 3x3 conv loads each input
// element once per tap: for it the float mode takes whole output rows
// per block (R <= BM / Wo rows, where BM holds one) and quantises the
// (R - 1) * stride + 3 input rows they read, a zero column at either end,
// once per 64 channels into a patch in shared memory, from which
// ldmatrix gathers each tap's A rows by pixel address (at stride 1, 5-7x
// less quantisation at 20x20-80x80; the rows past R * Wo compute on
// pixel 0 and are dropped). Where its bf16 rows are 16-byte aligned, the
// patch's inputs come by cp.async into a raw staging area (two when there
// are more than 64 channels: the next 64 channels' copies fly during
// this 64's products) and are quantised from there, so no raw input
// occupies registers; else (stride 2, C = 51, float32) through
// registers. The host
// gives a patch the most rows R that fit 110 KB of shared memory. A 1x1
// conv reads each element once per tile either way and goes tap by tap.
// The epilogue converts each sum to float (round to nearest), multiplies
// by scale and adds the bias as two operations (built with -fmad=false),
// rounds once to the output type (bf16 to nearest even), stages the tile
// in shared memory and writes 16-byte rows where O % 8 == 0, else masked
// elements (O = 51 and 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;          // output channels per block
constexpr int kStep = 32;        // reduction bytes per step: a tap, 32 channels
constexpr int kStageSteps = 2;   // steps per ring stage
constexpr int kRow = kStep * kStageSteps;  // bytes of a tile row per stage
constexpr int kStages = 4;       // ring depth
constexpr int kPitch = kBN + 8;  // elements per row of the staged output

enum { kInInt8 = 0, kInBf16 = 1, kInF32 = 2 };     // input modes
enum { kOutBf16 = 0, kOutF32 = 1, kOutI32 = 2 };   // output types
// How a block gets its A operand: a tile per ring stage, one tap at a
// time; or a patch of whole input rows, quantised once per 64 channels,
// loaded through registers or by cp.async into a raw bf16 staging area.
enum { kFillTap = 0, kFillRegs = 1, kFillAsync = 2 };
constexpr int kPatchSmem = 110 * 1024;  // a patch block's shared memory

struct Shape {
  int B, H, W;       // input pixels
  int C, ps;         // channels read, pixel stride (elements)
  int Cp;            // channels of a packed weight row (C padded to 32)
  int Ho, Wo, O, Op; // output [B, Ho, Wo, O]; weights [Op, KS * KS, Cp]
  int out_type;      // kOut*
  int vec_in;        // float mode: 16-byte loads where C allows
  int vec_out;       // 16-byte output rows (O % 8 == 0, aligned)
  int R;             // a patch's output rows (float mode, 3x3)
};

#ifndef POSEBYTE_CUDA_EMULATION
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronous; src_bytes = 0 writes 16 zeros
// (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of the committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Four 8 x 16-byte matrices from shared memory; lane l gives the address
// of row l % 8 of matrix l / 8 and receives in r[j] bytes 4 (l % 4) ..
// + 3 of row l / 4 of matrix j.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// d += a (16 x 32 s8, row-major) * b (32 x 8 s8, column-major), s32.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#endif

// float32 -> bfloat16 bits, round to nearest even (the conversion of
// XLA's astype(bfloat16) and of __float2bfloat16_rn); the pipeline's
// values are finite, and a NaN stays a NaN.
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  const unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

// Byte offset of 16-byte chunk `chunk` of tile row `row` (64-byte rows).
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kRow + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// Shared memory of a patch block: the int8 patch, the B ring and, filled
// by cp.async, the patch's bf16 inputs.
__host__ __device__ inline size_t patch_smem(int R, int ks, int stride,
                                             int W, int Cp, int fill) {
  const size_t px = (size_t)((R - 1) * stride + ks) * (W + ks - 1);
  const int n_raw = fill != kFillAsync ? 0 : Cp > kRow ? 2 : 1;
  return px * kRow * (1 + 2 * n_raw) + (size_t)kStages * kBN * kRow;
}

template <int IN> struct In;
template <> struct In<kInInt8> { using T = int8_t; };
template <> struct In<kInBf16> { using T = uint16_t; };
template <> struct In<kInF32> { using T = float; };

// The 16 input elements of one A chunk held in registers (float mode):
// bf16 two per word, float32 one.
template <int IN> struct Raw {
  static constexpr int kWords = IN == kInBf16 ? 8 : 16;
  unsigned u[kWords];
};

template <int IN>
__device__ __forceinline__ float raw_at(const Raw<IN>& r, int e) {
  if constexpr (IN == kInBf16)
    return __uint_as_float(((r.u[e >> 1] >> (16 * (e & 1))) & 0xffffu) << 16);
  else
    return __uint_as_float(r.u[e]);
}

// A patch (3x3, float input): a block computes R <= BM / Wo whole output
// rows of one image (the host's s.R), and its input rows ((R - 1) *
// STRIDE + 3, with a zero column each side) are quantised once per 64
// channels into a patch in shared memory, from which ldmatrix gathers each
// tap's A rows; else (kFillTap) each ring stage brings its own A tile.
// 16 elements of one chunk into registers: the first `live` from p (16-byte
// loads where vec), the rest 0.
template <int IN>
__device__ __forceinline__ void load16(const typename In<IN>::T* p, int live,
                                       int vec, Raw<IN>& raw) {
  constexpr int kVec = 16 / sizeof(typename In<IN>::T);  // per 16 bytes
  constexpr int kW = kVec * sizeof(typename In<IN>::T) / 4;
#pragma unroll
  for (int v = 0; v < 16 / kVec; ++v) {
    if (vec && live >= (v + 1) * kVec) {
      const uint4 q = *reinterpret_cast<const uint4*>(p + v * kVec);
      raw.u[v * kW + 0] = q.x;
      raw.u[v * kW + 1] = q.y;
      raw.u[v * kW + 2] = q.z;
      raw.u[v * kW + 3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int i = v * kVec + e;
        unsigned bits = 0;
        if (i < live) {
          if constexpr (IN == kInBf16)
            bits = p[i];
          else
            bits = __float_as_uint(p[i]);
        }
        if constexpr (IN == kInBf16) {
          if (e & 1)
            raw.u[i >> 1] |= bits << 16;
          else
            raw.u[i >> 1] = bits;
        } else {
          raw.u[i] = bits;
        }
      }
    }
  }
}

// The chunk quantised, q = clamp(rint(x / s_x), -127, 127), stored as 16
// int8 at dst; a chunk of zeros (the halo, the padded channels) skips the
// divisions.
template <int IN>
__device__ __forceinline__ void quantise16(unsigned char* dst,
                                           const Raw<IN>& raw, float sx) {
  unsigned q[4] = {0u, 0u, 0u, 0u}, any = 0u;
#pragma unroll
  for (int i = 0; i < Raw<IN>::kWords; ++i) any |= raw.u[i];
  if (any) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float v =
          fminf(fmaxf(rintf(__fdiv_rn(raw_at<IN>(raw, e), sx)), -127.0f),
                127.0f);
      q[e >> 2] |= ((unsigned)(int)v & 0xffu) << (8 * (e & 3));
    }
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
}

template <int KS, int STRIDE, int BM, int IN, int FILL>
__global__ void __launch_bounds__(2 * BM)
    conv_int8_kernel(const void* __restrict__ xv,
                     const float* __restrict__ s_x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, void* __restrict__ out,
                     Shape s) {
  constexpr bool PATCH = FILL != kFillTap;
  static_assert(!PATCH || (KS == 3 && IN != kInInt8), "");
  static_assert(FILL != kFillAsync || IN == kInBf16, "");
  using InT = typename In<IN>::T;
  constexpr int kThreads = 2 * BM;
  constexpr int kAStage = BM * kRow;
  constexpr int kBStage = kBN * kRow;
  constexpr int kBPieces = kBN * 4 / kThreads;  // B chunks per thread
  constexpr int kBatch = IN == kInF32 ? 2 : 4;  // patch chunks in flight
  extern __shared__ int4 smem[];
  unsigned char* As = reinterpret_cast<unsigned char*>(smem);

  const InT* x = static_cast<const InT*>(xv);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_tiles = s.Op / kBN;
  const int mt = (int)(blockIdx.x / n_tiles);
  const int n_base = (int)(blockIdx.x % n_tiles) * kBN;
  const int HWo = s.Ho * s.Wo;
  const int M = s.B * HWo;
  const int c_steps = s.Cp / kStep;
  const int steps_total = KS * KS * c_steps;
  // Patch geometry: output rows oy0 .. oy0 + rows - 1 of image pb, input
  // rows from iy0 = oy0 * STRIDE - KS / 2 as p_rows patch rows of PW
  // pixels (x = -KS / 2 .. W - 1 + KS / 2); T taps per 64 channels, in
  // n_cs stages of 64 channels, the raw bf16 of n_raw of them in flight.
  const int R = PATCH ? s.R : 1;
  const int tiles_per_img = (s.Ho + R - 1) / R;
  const int pb = mt / tiles_per_img, oy0 = (mt % tiles_per_img) * R;
  const int rows = s.Ho - oy0 < R ? s.Ho - oy0 : R;
  constexpr int T = KS * KS;
  const int PW = s.W + KS - 1, iy0 = oy0 * STRIDE - KS / 2;
  const int p_rows = (rows - 1) * STRIDE + KS;
  const int n_cs = (s.Cp + kRow - 1) / kRow, n_raw = n_cs > 1 ? 2 : 1;
  const int m_base = PATCH ? (pb * s.Ho + oy0) * s.Wo : mt * BM;
  const int m_count = PATCH ? rows * s.Wo
                            : (M - m_base < BM ? M - m_base : BM);
  // ring stages: 64 bytes of the reduction each; in a patch, T taps of
  // each 64 channels
  const int steps = PATCH ? n_cs * T
                          : (steps_total + kStageSteps - 1) / kStageSteps;
  const int patch_px = ((R - 1) * STRIDE + KS) * PW;
  unsigned char* Bs = As + (PATCH ? patch_px * kRow : kStages * kAStage);
  // kFillAsync: the patch's bf16 inputs, n_raw x [patch_px][64] after the
  // B ring
  uint16_t* Rs = reinterpret_cast<uint16_t*>(Bs + kStages * kBStage);

  // The loaders: thread t brings 16-byte chunk t % 4 of a stage's rows
  // (step (t % 4) / 2 of the stage, half t % 2), A rows t / 4 and
  // t / 4 + BM / 2, and B rows t / 4 + i * kThreads / 4.
  const int piece = tid & 3;
  int a_iy0[2], a_ix0[2];
  bool a_ok[2];
  const InT* a_img[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m_base + (tid >> 2) + r * (BM / 2);
    a_ok[r] = !PATCH && m < M;
    const int b = a_ok[r] ? m / HWo : 0;
    const int rem = a_ok[r] ? m - b * HWo : 0;
    a_iy0[r] = (rem / s.Wo) * STRIDE - KS / 2;
    a_ix0[r] = (rem % s.Wo) * STRIDE - KS / 2;
    a_img[r] = x + (size_t)b * s.H * s.W * s.ps;
  }
  const int8_t* w_tile = w + (size_t)n_base * KS * KS * s.Cp;
  float sx = 1.0f;
  if constexpr (IN != kInInt8) sx = *s_x;

  // The tap and first channel of this thread's chunk in ring stage `st`;
  // false past the reduction.
  auto step_at = [&](int st, int& tap, int& c0) {
    if constexpr (PATCH) {
      tap = st % T;
      c0 = st / T * kRow + piece * 16;
      return st < steps && c0 < s.Cp;
    }
    const int step = st * kStageSteps + (piece >> 1);
    tap = step / c_steps;
    c0 = (step - tap * c_steps) * kStep + (piece & 1) * 16;
    return step < steps_total;
  };
  // Channel c of A row r's input pixel at tap `tap`; null outside the
  // image or past M (the same padding: zeros).
  auto a_src = [&](int r, int tap, int c) -> const InT* {
    const int iy0 = a_iy0[r], ix0 = a_ix0[r];
    const int iy = iy0 + tap / KS, ix = ix0 + tap % KS;
    if (!a_ok[r] || iy < 0 || iy >= s.H || ix < 0 || ix >= s.W)
      return nullptr;
    return a_img[r] + ((size_t)iy * s.W + ix) * s.ps + c;
  };
  auto issue_b = [&](int st) {
    unsigned char* dst = Bs + (st % kStages) * kBStage;
    int tap, c0;
    const bool ok = step_at(st, tap, c0);
#pragma unroll 1
    for (int i = 0; i < kBPieces; ++i) {
      const int row = (tid >> 2) + i * (kThreads / 4);
      const int8_t* src =
          ok ? w_tile + ((size_t)row * KS * KS + tap) * s.Cp + c0 : w;
      cp_async_16(dst + swz(row, piece), src, ok ? 16 : 0);
    }
  };
  auto issue_a = [&](int st) {    // int8 mode
    unsigned char* dst = As + (st % kStages) * kAStage;
    int tap, c0;
    const bool ok = step_at(st, tap, c0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const InT* src = ok ? a_src(r, tap, c0) : nullptr;
      cp_async_16(dst + swz((tid >> 2) + r * (BM / 2), piece),
                  src ? src : x, src ? 16 : 0);
    }
  };

  // Float mode: 16 channels c0 .. c0 + 15 of a pixel (src points at c0;
  // null: a zero pixel) into registers; channels from C on read as 0.
  auto load_chunk = [&](const InT* src, int c0, Raw<IN>& raw) {
    load16<IN>(src ? src : x, src ? s.C - c0 : 0, s.vec_in, raw);
  };
  auto quant_store = [&](unsigned char* dst, const Raw<IN>& raw) {
    quantise16<IN>(dst, raw, sx);
  };
  Raw<IN> raw[2];
  auto load_a = [&](int st) {
    int tap, c0;
    const bool ok = step_at(st, tap, c0);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      load_chunk(ok ? a_src(r, tap, c0) : nullptr, c0, raw[r]);
  };
  auto store_a = [&](int st) {
    unsigned char* dst = As + (st % kStages) * kAStage;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      quant_store(dst + swz((tid >> 2) + r * (BM / 2), piece), raw[r]);
  };
  // Patch: channels cs * 64 .. + 63 of its p_rows x PW pixels,
  // quantised, as 64-byte rows (zeros outside the image), kBatch chunks
  // of each thread in flight at once.
  auto fill_patch = [&](int cs) {
    const int n_chunks = p_rows * PW * 4;
    for (int i0 = tid; i0 < n_chunks; i0 += kThreads * kBatch) {
      Raw<IN> rb[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads, q = i >> 2;
        const int c0 = cs * kRow + (i & 3) * 16;
        const int iy = iy0 + q / PW, ix = q % PW - KS / 2;
        const bool in = i < n_chunks && iy >= 0 && iy < s.H && ix >= 0 &&
                        ix < s.W;
        load_chunk(in ? x + (((size_t)pb * s.H + iy) * s.W + ix) * s.ps + c0
                      : nullptr,
                   c0, rb[j]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = i0 + j * kThreads;
        if (i < n_chunks) quant_store(As + swz(i >> 2, i & 3), rb[j]);
      }
    }
  };

  // kFillAsync: channels cs * 64 .. + 63 of the patch's pixels as bf16
  // into raw buffer cs % n_raw by 16-byte copies (zeros outside the image
  // and from C on).
  auto issue_raw = [&](int cs) {
    uint16_t* dst = Rs + (size_t)(cs % n_raw) * patch_px * kRow;
#pragma unroll 1
    for (int i = tid; i < p_rows * PW * 8; i += kThreads) {
      const int q = i >> 3, c0 = cs * kRow + (i & 7) * 8;
      const int iy = iy0 + q / PW, ix = q % PW - KS / 2;
      const bool in = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W &&
                      c0 < s.C;
      const int n = in ? 2 * (s.C - c0) : 0;   // bytes to copy, the rest 0
      cp_async_16(dst + q * kRow + (i & 7) * 8,
                  in ? x + (((size_t)pb * s.H + iy) * s.W + ix) * s.ps + c0
                     : x,
                  n > 16 ? 16 : n);
    }
  };
  // kFillAsync: raw buffer cs % n_raw quantised into the patch.
  auto quantise_raw = [&](int cs) {
    const uint16_t* raw = Rs + (size_t)(cs % n_raw) * patch_px * kRow;
#pragma unroll 1
    for (int i = tid; i < p_rows * PW * 4; i += kThreads) {
      const uint4* src = reinterpret_cast<const uint4*>(raw + (i >> 2) * kRow +
                                                        (i & 3) * 16);
      Raw<IN> r;
      const uint4 lo = src[0], hi = src[1];
      r.u[0] = lo.x; r.u[1] = lo.y; r.u[2] = lo.z; r.u[3] = lo.w;
      r.u[4] = hi.x; r.u[5] = hi.y; r.u[6] = hi.z; r.u[7] = hi.w;
      quant_store(As + swz(i >> 2, i & 3), r);
    }
  };

  // The products: warp (wm, wn) owns rows wm * 32 .. + 31 and channels
  // wn * 32 .. + 31 of the tile, as 2 x 4 m16n8 accumulators.
  const int wm = warp >> 1, wn = warp & 1;
  const int sw = (lane >> 1) & 3;  // the swizzle of this lane's ldmatrix rows
  const int a_ld = (wm * 32 + (lane & 15)) * kRow;
  const int b_ld = (wn * 32 + ((lane >> 4) << 3) + (lane & 7)) * kRow;
  // Patch: the patch pixel under tap 0 of this lane's ldmatrix rows (an
  // output pixel past the tile reads pixel 0; its sums are dropped).
  int a_q0[2] = {0, 0};
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int i = wm * 32 + mi * 16 + (lane & 15);
    if (PATCH && i < m_count)
      a_q0[mi] = (i / s.Wo * PW + i % s.Wo) * STRIDE;
  }
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  auto compute = [&](int st) {
    const int slot = st % kStages;
    const unsigned char* b = Bs + slot * kBStage + b_ld;
    int a_row[2], a_sw[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if constexpr (PATCH) {
        const int q = a_q0[mi] + st % T / KS * PW + st % KS;
        a_row[mi] = q * kRow;
        a_sw[mi] = (q >> 1) & 3;
      } else {
        a_row[mi] = slot * kAStage + a_ld + mi * 16 * kRow;
        a_sw[mi] = sw;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kStageSteps; ++kk) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], As + a_row[mi] +
                                (((kk * 2 + (lane >> 4)) ^ a_sw[mi]) << 4));
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(bf[nj], b + nj * 16 * kRow +
                                (((kk * 2 + ((lane >> 3) & 1)) ^ sw) << 4));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8_16832(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                       bf[ni >> 1][(ni & 1) * 2 + 1]);
    }
  };

  // The ring: stages 0 .. kStages - 2 in flight before the loop; stage
  // step + kStages - 1 issued once every thread is past stage step - 1.
  if constexpr (FILL == kFillAsync) {
    issue_raw(0);
    cp_async_commit();
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) {
      if constexpr (IN == kInInt8) issue_a(st);
      issue_b(st);
    }
    cp_async_commit();
  }
  if constexpr (FILL == kFillTap && IN != kInInt8) {
    load_a(0);
    store_a(0);
    if (1 < steps) load_a(1);
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if constexpr (PATCH) {
      if (step % T == 0) {   // the patch of the next 64 channels
        const int cs = step / T;
        if constexpr (FILL == kFillAsync) {
          cp_async_wait<0>();   // raw(cs) landed (one barrier for all)
          __syncthreads();
          if (cs + 1 < n_cs) {  // the other raw buffer is free
            issue_raw(cs + 1);
            cp_async_commit();
          }
          quantise_raw(cs);
        } else {
          fill_patch(cs);
        }
        __syncthreads();
      }
    }
    const int next = step + kStages - 1;
    if (next < steps) {
      if constexpr (IN == kInInt8) issue_a(next);
      issue_b(next);
    }
    cp_async_commit();
    if constexpr (FILL == kFillTap && IN != kInInt8) {
      if (step + 1 < steps) store_a(step + 1);
      if (step + 2 < steps) load_a(step + 2);
    }
    compute(step);
  }
  cp_async_wait<0>();
  __syncthreads();

  // The epilogue, staged in shared memory as [BM][kPitch] output values.
  const int g = lane >> 2, t4 = lane & 3;
  const int esz = s.out_type == kOutBf16 ? 2 : 4;
  unsigned char* st_out = As;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wm * 32 + mi * 16 + g + 8 * hh;
        const int col = wn * 32 + ni * 8 + 2 * t4;
        unsigned bits[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = acc[mi][ni][hh * 2 + e];
          const int n = n_base + col + e;
          if (s.out_type == kOutI32) {
            bits[e] = (unsigned)a;
          } else {
            float v = 0.0f;
            if (n < s.O) {
              v = (float)a * scale[n];
              if (bias != nullptr) v = v + bias[n];
            }
            bits[e] = s.out_type == kOutBf16 ? bf16_bits(v)
                                             : __float_as_uint(v);
          }
        }
        unsigned char* p = st_out + (row * kPitch + col) * esz;
        if (esz == 2)
          *reinterpret_cast<unsigned*>(p) = bits[0] | (bits[1] << 16);
        else
          *reinterpret_cast<uint2*>(p) = make_uint2(bits[0], bits[1]);
      }
  __syncthreads();
  const int per = 16 / esz;                  // elements per 16 bytes
  const int chunks = kBN / per;
  for (int i = tid; i < BM * chunks; i += kThreads) {
    const int row = i / chunks, n0 = n_base + (i % chunks) * per;
    if (row >= m_count || n0 >= s.O) continue;
    const unsigned char* src = st_out + (row * kPitch + (n0 - n_base)) * esz;
    unsigned char* dst = static_cast<unsigned char*>(out) +
                         ((size_t)(m_base + row) * s.O + n0) * esz;
    if (s.vec_out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else if (esz == 2) {
      for (int e = 0; e < per && n0 + e < s.O; ++e)
        reinterpret_cast<uint16_t*>(dst)[e] =
            reinterpret_cast<const uint16_t*>(src)[e];
    } else {
      for (int e = 0; e < per && n0 + e < s.O; ++e)
        reinterpret_cast<unsigned*>(dst)[e] =
            reinterpret_cast<const unsigned*>(src)[e];
    }
  }
}

template <int KS, int STRIDE, int BM, int IN, int FILL>
cudaError_t run(const void* x, const float* s_x, const int8_t* w,
                const float* scale, const float* bias, void* out,
                const Shape& s, cudaStream_t stream) {
  auto kernel = conv_int8_kernel<KS, STRIDE, BM, IN, FILL>;
  long long m_tiles = ((long long)s.B * s.Ho * s.Wo + BM - 1) / BM;
  size_t smem = (size_t)kStages * (BM + kBN) * kRow;
  if (FILL != kFillTap) {
    m_tiles = (long long)s.B * ((s.Ho + s.R - 1) / s.R);
    smem = patch_smem(s.R, KS, STRIDE, s.W, s.Cp, FILL);
  }
  const size_t staged = (size_t)BM * kPitch * 4;   // the epilogue's tile
  if (smem < staged) smem = staged;
  const long long grid = m_tiles * (s.Op / kBN);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<(int)grid, 2 * BM, smem, stream>>>(x, s_x, w, scale, bias, out,
                                               s);
  return cudaGetLastError();
}

template <int KS, int STRIDE, int BM>
cudaError_t run(int in_type, const void* x, const float* s_x,
                const int8_t* w, const float* scale, const float* bias,
                void* out, Shape s, cudaStream_t stream) {
  if constexpr (KS == 3) {
    // a patch of whole rows: the most output rows a block holds whose
    // patch fits kPatchSmem, filled by cp.async where the rows allow and
    // the stride is 1 (at stride 2 the register fill, with no staging
    // area, gets more rows per block and runs faster; a 1x1 conv reads
    // each element once per tile either way, and runs faster tap by tap)
    const int fill = in_type == kInBf16 && s.vec_in && STRIDE == 1
                         ? kFillAsync
                         : kFillRegs;
    for (s.R = BM / s.Wo; s.R > 0; --s.R)
      if (patch_smem(s.R, KS, STRIDE, s.W, s.Cp, fill) <= kPatchSmem) break;
    if (in_type != kInInt8 && s.R > 0) {
      if (fill == kFillAsync)
        return run<KS, STRIDE, BM, kInBf16, kFillAsync>(x, s_x, w, scale,
                                                        bias, out, s, stream);
      if (in_type == kInBf16)
        return run<KS, STRIDE, BM, kInBf16, kFillRegs>(x, s_x, w, scale,
                                                       bias, out, s, stream);
      return run<KS, STRIDE, BM, kInF32, kFillRegs>(x, s_x, w, scale, bias,
                                                    out, s, stream);
    }
  }
  if (in_type == kInBf16)
    return run<KS, STRIDE, BM, kInBf16, kFillTap>(x, s_x, w, scale, bias, out,
                                                  s, stream);
  if (in_type == kInF32)
    return run<KS, STRIDE, BM, kInF32, kFillTap>(x, s_x, w, scale, bias, out,
                                                 s, stream);
  return run<KS, STRIDE, BM, kInInt8, kFillTap>(x, s_x, w, scale, bias, out,
                                                s, stream);
}

template <int KS, int STRIDE>
cudaError_t run(int tile_m, int in_type, const void* x, const float* s_x,
                const int8_t* w, const float* scale, const float* bias,
                void* out, const Shape& s, cudaStream_t stream) {
  if (tile_m == 128)
    return run<KS, STRIDE, 128>(in_type, x, s_x, w, scale, bias, out, s,
                                stream);
  if (tile_m == 64)
    return run<KS, STRIDE, 64>(in_type, x, s_x, w, scale, bias, out, s,
                               stream);
  return run<KS, STRIDE, 32>(in_type, x, s_x, w, scale, bias, out, s,
                             stream);
}

}  // namespace

// One launch of Kernel 4 on `stream`; returns the launch status.
//   x         [B, H, W, *] NHWC with pixel stride `ps` elements and channel
//             stride 1: in_type 0 int8 (already quantised; C == ps == Cp,
//             16-byte aligned), 1 bfloat16, 2 float32 (quantised in the
//             load with the scale at s_x, a device pointer to one float;
//             channels C .. Cp - 1 read as 0)
//   w         [Op, ks * ks, Cp] int8, 16-byte aligned (Cp a multiple of 32,
//             C <= Cp < C + 32; Op a multiple of 64, O <= Op)
//   scale     [O] float32, bias [O] float32 or null
//   out       [B, Ho, Wo, O]: bfloat16 (out_type 0), float32 (1), or the
//             int32 sums without the epilogue (2)
//   (ks, stride) in {(3, 1), (3, 2), (1, 1)}, padding ks / 2; tile_m, the
//   output pixels per block, in {32, 64, 128}.
extern "C" cudaError_t posebyte_conv_int8(
    const void* x, int in_type, const float* s_x, int ps, int C,
    const int8_t* w, const float* scale, const float* bias, void* out, int B,
    int H, int W, int Cp, int O, int Op, int ks, int stride, int out_type,
    int tile_m, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Cp % kStep != 0 || C > Cp ||
      C <= Cp - kStep || ps < C || O <= 0 || Op < O || Op % kBN != 0 ||
      out_type < 0 || out_type > 2 || in_type < 0 || in_type > 2 ||
      (tile_m != 32 && tile_m != 64 && tile_m != 128))
    return cudaErrorInvalidValue;
  const bool shape_ok = (ks == 3 && (stride == 1 || stride == 2)) ||
                        (ks == 1 && stride == 1);
  if (!shape_ok) return cudaErrorInvalidValue;
  const size_t in_size = in_type == kInInt8 ? 1 : in_type == kInBf16 ? 2 : 4;
  if (in_type == kInInt8 &&
      (C != Cp || ps != Cp || reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return cudaErrorInvalidValue;
  if (in_type != kInInt8 &&
      (s_x == nullptr || reinterpret_cast<uintptr_t>(x) % in_size != 0))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0) return cudaErrorInvalidValue;
  const int pad = ks / 2;
  const int vec_in = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     (ps * in_size) % 16 == 0;
  const int vec_out = O % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  Shape s{B, H, W, C, ps, Cp, (H + 2 * pad - ks) / stride + 1,
          (W + 2 * pad - ks) / stride + 1, O, Op, out_type, vec_in, vec_out,
          1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks == 1)
    return run<1, 1>(tile_m, in_type, x, s_x, w, scale, bias, out, s, st);
  if (stride == 2)
    return run<3, 2>(tile_m, in_type, x, s_x, w, scale, bias, out, s, st);
  return run<3, 1>(tile_m, in_type, x, s_x, w, scale, bias, out, s, st);
}

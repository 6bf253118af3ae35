// Kernel 4: an int8 convolution as an implicit GEMM, int32 accumulation,
// the per-output-channel dequantisation fused as its epilogue.
//
// Replaces posebyte_tpu/ops/pallas_conv.py::conv3x3_int8_pallas
// (_conv3x3_kernel): a 3x3, same-padding, stride-1 convolution of int8 NHWC
// activations with int8 weights, summed in int32, then
//   out = bf16(float(acc) * scale[o])            (scale = s_x * s_w[o])
// The same source also carries the JAX package's other w8a8 convolutions
// (posebyte_tpu/models/layers.py::conv2d, its act_scale branch: 3x3 stride 2
// and 1x1, with a bias): out = round(float(acc) * scale[o] + bias[o]) in the
// activation type, bf16 or float32. The three shapes are template
// parameters (KS, STRIDE) in {(3, 1), (3, 2), (1, 1)}.
//
// As a GEMM: M = B * Ho * Wo output pixels, N = O output channels,
// K = KS * KS * Cp reduction bytes, Cp the input channels padded to a
// multiple of 32 with zeros (the quantisation pass writes them,
// ops/conv_int8.py::quantize_activation). Weights are packed once as
// [Op][KS * KS][Cp] int8 (Op = O padded to a multiple of 64 with zero
// rows), so an output channel's reduction is contiguous.
//
// What bounds it on an H100: the card moves 3.35 TB/s and does 1,979 int8
// TOP/s, ~590 operations per byte. Most of yolov8n-pose's convolutions do
// fewer per byte moved (a 3x3 conv of 64 channels at 80x80, ~380; the 1x1
// ones fewer still, their bf16 output dominating), so their bound is the
// bytes; the 3x3 convs of 128-256 channels at 20x20 are bound by
// operations. Over a chunk of 128 frames: 3.8 GB and 975 GOP, 1.13 ms by
// bytes. This first kernel is far from both: it computes with __dp4a (four
// int8 products into an int32 per instruction, on the CUDA cores, ~120-130
// TOP/s at most), which is exact and simple; the int8 peak needs the
// tensor cores. Making it fast (mma.sync or wgmma on s8 tiles fed by
// cp.async or TMA) is later work.
//
// Design: one block of 256 threads per 128 x 64 output tile (grid =
// M tiles * N tiles, one dimension). The reduction walks steps of 32 bytes:
// one tap (dy, dx) and 32 input channels, so each pixel's row of a step is
// 32 contiguous bytes of x (two 16-byte loads; zeros outside the image,
// the same padding) and each channel's row 32 contiguous bytes of the
// packed weights. A step's tiles go to shared memory as int32 words,
// k-major ([8 words][128 pixels], [8 words][64 channels], rows padded so
// that the transposing stores hit distinct banks); the next step's loads
// are in registers while this step computes. Each thread owns 8 pixels x 4
// channels of int32 sums in registers. The epilogue converts each sum to
// float (round to nearest), multiplies by scale and adds the bias as two
// operations (built with -fmad=false), and rounds once to the output type
// (bf16 round to nearest even).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;        // output pixels per block
constexpr int kBN = 64;         // output channels per block
constexpr int kBK = 32;         // reduction bytes per step
constexpr int kWords = kBK / 4; // int32 words of a step's row
constexpr int kPadA = kBM + 16; // shared row lengths (words): the two
constexpr int kPadB = kBN + 16; // halves of a store land 16 banks apart
constexpr int kThreads = 256;
constexpr int kTM = 8;          // pixels per thread
constexpr int kTN = 4;          // channels per thread

struct Shape {
  int B, H, W, Cp;   // input [B, H, W, Cp] int8
  int Ho, Wo, O, Op; // output [B, Ho, Wo, O]; weights [Op, KS * KS, Cp]
};

// float32 -> bfloat16 bits, round to nearest even (the conversion of
// XLA's astype(bfloat16) and of __float2bfloat16_rn); the pipeline's
// values are finite, and a NaN stays a NaN.
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  const unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((u >> 16) | 0x40u);
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ void store(uint16_t* p, float v) {
  *p = bf16_bits(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int KS, int STRIDE, class OutT>
__global__ void __launch_bounds__(kThreads)
    conv_int8_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, OutT* __restrict__ out,
                     Shape s) {
  extern __shared__ int32_t smem[];
  int32_t* As = smem;                   // [kWords][kPadA]
  int32_t* Bs = smem + kWords * kPadA;  // [kWords][kPadB]

  const int tid = threadIdx.x;
  const int n_tiles = s.Op / kBN;
  const int m_base = (int)(blockIdx.x / n_tiles) * kBM;
  const int n_base = (int)(blockIdx.x % n_tiles) * kBN;
  const int HWo = s.Ho * s.Wo;
  const int M = s.B * HWo;

  // The loaders: thread t brings the 16-byte half (t & 1) of pixel row
  // t >> 1 of the A tile, and threads below 128 that of channel row
  // t >> 1 of the B tile.
  const int half = tid & 1;
  const int a_row = tid >> 1;
  const int m = m_base + a_row;
  const bool m_ok = m < M;
  int b = 0, iy0 = 0, ix0 = 0;
  if (m_ok) {
    b = m / HWo;
    const int r = m - b * HWo;
    iy0 = (r / s.Wo) * STRIDE - KS / 2;
    ix0 = (r % s.Wo) * STRIDE - KS / 2;
  }
  const bool b_loader = tid < 2 * kBN;
  const int8_t* w_row =
      w + ((size_t)(n_base + (a_row & (kBN - 1))) * KS * KS) * s.Cp +
      half * 16;
  const int c_steps = s.Cp / kBK;
  const int steps = KS * KS * c_steps;

  int4 ra = make_int4(0, 0, 0, 0), rb = make_int4(0, 0, 0, 0);
  auto fetch = [&](int step) {
    const int tap = step / c_steps;
    const int c0 = (step - tap * c_steps) * kBK;
    const int iy = iy0 + tap / KS, ix = ix0 + tap % KS;
    ra = make_int4(0, 0, 0, 0);
    if (m_ok && iy >= 0 && iy < s.H && ix >= 0 && ix < s.W)
      ra = *reinterpret_cast<const int4*>(
          x + (((size_t)b * s.H + iy) * s.W + ix) * s.Cp + c0 + half * 16);
    if (b_loader)
      rb = *reinterpret_cast<const int4*>(w_row + (size_t)tap * s.Cp + c0);
  };

  const int ty = tid / (kBN / kTN);     // pixels ty * 8 .. + 7
  const int tx = tid % (kBN / kTN);     // channels tx * 4 .. + 3
  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  fetch(0);
  for (int step = 0; step < steps; ++step) {
    // word j of a row holds bytes 4j .. 4j + 3 of the step's 32
    As[(half * 4 + 0) * kPadA + a_row] = ra.x;
    As[(half * 4 + 1) * kPadA + a_row] = ra.y;
    As[(half * 4 + 2) * kPadA + a_row] = ra.z;
    As[(half * 4 + 3) * kPadA + a_row] = ra.w;
    if (b_loader) {
      Bs[(half * 4 + 0) * kPadB + a_row] = rb.x;
      Bs[(half * 4 + 1) * kPadB + a_row] = rb.y;
      Bs[(half * 4 + 2) * kPadB + a_row] = rb.z;
      Bs[(half * 4 + 3) * kPadB + a_row] = rb.w;
    }
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1);   // in flight while we compute
#pragma unroll
    for (int kk = 0; kk < kWords; ++kk) {
      const int4 a0 =
          *reinterpret_cast<const int4*>(As + kk * kPadA + ty * kTM);
      const int4 a1 =
          *reinterpret_cast<const int4*>(As + kk * kPadA + ty * kTM + 4);
      const int4 bv = *reinterpret_cast<const int4*>(Bs + kk * kPadB +
                                                     tx * kTN);
      const int a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bw[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = __dp4a(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int mo = m_base + ty * kTM + i;
    if (mo >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n_base + tx * kTN + j;
      if (n >= s.O) continue;
      if constexpr (std::is_same<OutT, int32_t>::value) {
        out[(size_t)mo * s.O + n] = acc[i][j];
      } else {
        float v = (float)acc[i][j] * scale[n];
        if (bias != nullptr) v = v + bias[n];
        store(out + (size_t)mo * s.O + n, v);
      }
    }
  }
}

template <int KS, int STRIDE, class OutT>
cudaError_t run(const int8_t* x, const int8_t* w, const float* scale,
                const float* bias, void* out, const Shape& s, int grid,
                cudaStream_t stream) {
  void (*kernel)(const int8_t*, const int8_t*, const float*, const float*,
                 OutT*, Shape) = conv_int8_kernel<KS, STRIDE, OutT>;
  const size_t smem = (size_t)kWords * (kPadA + kPadB) * sizeof(int32_t);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, scale, bias,
                                           static_cast<OutT*>(out), s);
  return cudaGetLastError();
}

template <int KS, int STRIDE>
cudaError_t run(int out_type, const int8_t* x, const int8_t* w,
                const float* scale, const float* bias, void* out,
                const Shape& s, int grid, cudaStream_t stream) {
  if (out_type == 1)
    return run<KS, STRIDE, float>(x, w, scale, bias, out, s, grid, stream);
  if (out_type == 2)
    return run<KS, STRIDE, int32_t>(x, w, scale, bias, out, s, grid, stream);
  return run<KS, STRIDE, uint16_t>(x, w, scale, bias, out, s, grid, stream);
}

}  // namespace

// x [B, H, W, Cp] int8 (16-byte aligned; Cp a multiple of 32, as
// ops/conv_int8.py's C_ALIGN), w [Op, ks * ks, Cp] int8 (Op a multiple of
// 64, O_ALIGN), scale
// [O] f32, bias [O] f32 or null; out [B, Ho, Wo, O]: bfloat16 (out_type
// 0), float32 (1), or the int32 sums without the epilogue (2). (ks,
// stride) in {(3, 1), (3, 2), (1, 1)}, padding ks / 2.
// Launches on `stream`; returns the launch status.
extern "C" cudaError_t posebyte_conv_int8(const int8_t* x, const int8_t* w,
                                          const float* scale,
                                          const float* bias, void* out,
                                          int B, int H, int W, int Cp, int O,
                                          int Op, int ks, int stride,
                                          int out_type, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cp <= 0 || Cp % kBK != 0 || O <= 0 ||
      Op < O || Op % kBN != 0 || out_type < 0 || out_type > 2)
    return cudaErrorInvalidValue;
  const bool shape_ok = (ks == 3 && (stride == 1 || stride == 2)) ||
                        (ks == 1 && stride == 1);
  if (!shape_ok) return cudaErrorInvalidValue;
  const int pad = ks / 2;
  Shape s{B, H, W, Cp, (H + 2 * pad - ks) / stride + 1,
          (W + 2 * pad - ks) / stride + 1, O, Op};
  const long long M = (long long)B * s.Ho * s.Wo;
  const long long grid = (M + kBM - 1) / kBM * (Op / kBN);
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks == 1)
    return run<1, 1>(out_type, x, w, scale, bias, out, s, (int)grid, st);
  if (stride == 2)
    return run<3, 2>(out_type, x, w, scale, bias, out, s, (int)grid, st);
  return run<3, 1>(out_type, x, w, scale, bias, out, s, (int)grid, st);
}

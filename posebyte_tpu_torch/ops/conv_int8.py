"""The int8 convolution of the w8a8 path: Kernel 4's wrappers, their plain
versions, the activation quantisation and the weight packing it reads.
After posebyte_tpu/ops/pallas_conv.py (conv3x3_int8_pallas) and the
act_scale branch of posebyte_tpu/models/layers.py::conv2d.

    out = cast(float32(sum over taps and channels of int32(xq * wq))
               * scale [+ bias])

with scale = s_x * s_w (one float32 product per output channel), the
multiply and the add as two roundings, and one rounding to the output type
(bf16 to nearest even, or float32). With bias=None, k = 3, stride = 1 and a
bf16 output it is conv3x3_int8_pallas; with a bias it is the JAX w8a8
branch. Layouts: the quantised activation is NHWC int8 with its channels
padded with zeros to a multiple of C_ALIGN; the packed weights are
[Op, k * k, Cp] int8 (Op = O padded to a multiple of O_ALIGN with zero
rows), so that an output channel's reduction is contiguous; the output is
[B, O, Ho, Wo] in channels_last memory (NHWC bytes), as the port's
activations are.

Two entries, each launching Kernel 4 (csrc/conv_int8.cu) for a CUDA tensor
and running its plain version for a CPU tensor:
- conv_w8a8(x, s_x, ...) takes the float activation as the model holds it
  (bf16 or float32, channels_last, or a channel slice of such a tensor)
  and quantises it in the kernel's load: the path the pipeline runs, one
  launch and nothing else. Its plain version is quantize_activation then
  conv_int8_plain, the JAX branch's arithmetic.
- conv_int8(xq, ...) takes the quantised, channel-padded int8 activation
  (conv3x3_int8_pallas's contract).
conv_w8a8_op registers conv_w8a8 as the operator posebyte::conv_w8a8, for
the programs models/aot.py exports.
YOLO11's depthwise w8a8 convs (the JAX package's feature_group_count = C
int8 conv, plain XLA and no Pallas kernel) have no Kernel 4 mode:
conv_w8a8_depthwise runs them as a float32 depthwise conv of the
quantised values, exact because every sum is an integer below 2^24.
The plain version is exact: every
product of two int8 values and every partial sum of a convolution (at most
9 * Cp * 127^2, far below 2^53) is an integer that float64 holds exactly,
so a float64 convolution in any summation order gives the int32 sums.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_lib

C_ALIGN = 32     # input channels padded to a multiple (Kernel 4's step)
O_ALIGN = 64     # output channels of the packed weights (its block width)
SHAPES = ((3, 1), (3, 2), (1, 1))    # (k, stride) Kernel 4 instantiates
TILES_M = (128, 64, 32)              # output pixels per block it instantiates
_OUT_DTYPES = (torch.bfloat16, torch.float32, torch.int32)
_IN_DTYPES = (torch.int8, torch.bfloat16, torch.float32)   # its in_type


def padded(n: int, align: int) -> int:
    return -(-n // align) * align


def pack_weights(w) -> torch.Tensor:
    """int8 OIHW weights [O, C, k, k] (numpy or tensor) -> [Op, k * k, Cp]
    int8 on w's device, zero-padded."""
    w = torch.as_tensor(w)
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[2] != w.shape[3]:
        raise TypeError("pack_weights: int8 [O, C, k, k] weights")
    O, C, k, _ = w.shape
    out = torch.zeros((padded(O, O_ALIGN), k * k, padded(C, C_ALIGN)),
                      dtype=torch.int8, device=w.device)
    out[:O, :, :C] = w.permute(0, 2, 3, 1).reshape(O, k * k, C)
    return out


def _quantized(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """clamp(round(x / s_x), -127, 127) in float32, x's shape: the one
    quantisation rule of the port's eager paths (division on x's device,
    round half to even)."""
    return torch.clamp(torch.round(x.float() / s_x), -127, 127)


def quantize_activation(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] (any float type and memory format) -> int8 NHWC
    [B, H, W, Cp], clamp(round(x / s_x), -127, 127) with round half to
    even (jnp.round), Cp = C rounded up to C_ALIGN, channels C .. Cp - 1
    zero.

    s_x is a 0-d float32 tensor on x's device: on the card, ATen divides
    by a CPU scalar as a multiplication by its reciprocal, which can
    differ from x / s_x in the last bit and move a value across a .5
    rounding boundary."""
    if s_x.device != x.device:
        raise ValueError("quantize_activation: s_x must lie on x's device")
    B, C, H, W = x.shape
    q = _quantized(x, s_x).to(torch.int8)
    out = torch.zeros((B, H, W, padded(C, C_ALIGN)), dtype=torch.int8,
                      device=x.device)
    out[..., :C] = q.permute(0, 2, 3, 1)
    return out


def _check(xq, w_packed, scale, bias, k, stride, out_dtype):
    if xq.dtype != torch.int8 or xq.dim() != 4:
        raise TypeError("conv_int8: int8 activations xq [B, H, W, Cp]")
    _check_weights(xq.shape[-1], w_packed, scale, bias, k, stride,
                   out_dtype)


def _check_weights(Cp, w_packed, scale, bias, k, stride, out_dtype):
    """Kernel 4's weights, scale and bias for an activation of Cp
    (padded) channels, and its output type."""
    if w_packed.dtype != torch.int8 or w_packed.dim() != 3:
        raise TypeError("conv_int8: int8 weights [Op, k * k, Cp]")
    if (k, stride) not in SHAPES or w_packed.shape[1] != k * k:
        raise ValueError(f"conv_int8: (k, stride) = ({k}, {stride}) with "
                         f"weights {tuple(w_packed.shape)}")
    O = scale.shape[0]
    if w_packed.shape[2] != Cp or Cp % C_ALIGN \
            or w_packed.shape[0] % O_ALIGN or w_packed.shape[0] < O:
        raise ValueError(f"conv_int8: activations of {Cp} channels and "
                         f"weights {tuple(w_packed.shape)} are not padded "
                         "alike")
    if scale.dtype != torch.float32 or scale.dim() != 1 or (
            bias is not None and (bias.dtype != torch.float32
                                  or tuple(bias.shape) != (O,))):
        raise TypeError("conv_int8: scale and bias float32 [O]")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"conv_int8: output type {out_dtype}")


def _out_size(n: int, k: int, stride: int) -> int:
    return (n + 2 * (k // 2) - k) // stride + 1


def conv_int8_plain(xq: torch.Tensor, w_packed: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor | None, k: int,
                    stride: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain version on any device: the int32 sums by an exact float64
    convolution, then the same epilogue. out_dtype=torch.int32 returns the
    sums themselves."""
    _check(xq, w_packed, scale, bias, k, stride, out_dtype)
    O, Cp = scale.shape[0], xq.shape[-1]
    w = w_packed[:O].reshape(O, k, k, Cp).permute(0, 3, 1, 2).double()
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), w, stride=stride,
                   padding=k // 2)
    if out_dtype == torch.int32:
        y = acc.to(torch.int32)
    else:
        y = acc.float() * scale[:, None, None]
        if bias is not None:
            y = y + bias[:, None, None]
        y = y.to(out_dtype)
    return y.contiguous(memory_format=torch.channels_last)


def conv_w8a8_plain(x: torch.Tensor, s_x: torch.Tensor,
                    w_packed: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor | None, k: int, stride: int,
                    out_dtype=None) -> torch.Tensor:
    """The float-input convolution's plain version: quantize_activation,
    then conv_int8_plain; out_dtype defaults to x's."""
    return conv_int8_plain(quantize_activation(x, s_x), w_packed, scale,
                           bias, k, stride, out_dtype or x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_m(device: torch.device, B: int, Ho: int, Wo: int, O: int,
           patch: bool = False) -> int:
    """Kernel 4's output pixels per block for an output [B, O, Ho, Wo]: the
    largest of TILES_M that still gives every SM of the card a block (a
    batch of 128 frames takes 128), else the one giving the most blocks.
    patch: a 3x3 conv of a float input, whose blocks take whole output rows
    (the tile must hold one; else the kernel goes tap by tap)."""
    n_tiles = padded(O, O_ALIGN) // O_ALIGN
    tiles = [t for t in TILES_M if not patch or Wo <= t]
    if not tiles:
        tiles, patch = list(TILES_M), False

    def blocks(t):
        if patch:
            return B * -(-Ho // (t // Wo)) * n_tiles
        return -(-(B * Ho * Wo) // t) * n_tiles

    for t in tiles:
        if blocks(t) >= _sm_count(device.index or 0):
            return t
    return max(tiles, key=blocks)


def _launch(x, in_type, s_x, ps, C, w_packed, scale, bias, k, stride,
            out_dtype, what):
    """One Kernel 4 launch on x [B, *, H, W] (NHWC memory, pixel stride
    ps) -> [B, O, Ho, Wo] in channels_last memory."""
    dev = x.device
    tensors = [w_packed, scale] + ([] if bias is None else [bias]) \
        + ([] if s_x is None else [s_x])
    if not (x.is_cuda and all(t.is_cuda and t.device == dev
                              and t.is_contiguous() for t in tensors)):
        raise ValueError(f"{what}: inputs on one CUDA device, contiguous "
                         "weights, scale and bias")
    if w_packed.data_ptr() % 16:
        raise ValueError(f"{what}: packed weights must be 16-byte aligned")
    B, _, H, W = x.shape
    O = scale.shape[0]
    Ho, Wo = _out_size(H, k, stride), _out_size(W, k, stride)
    out = torch.empty((B, Ho, Wo, O), dtype=out_dtype, device=dev)
    status = cuda_lib.load().posebyte_conv_int8(
        x.data_ptr(), in_type, None if s_x is None else s_x.data_ptr(), ps,
        C, w_packed.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), B, H, W,
        w_packed.shape[2], O, w_packed.shape[0], k, stride,
        _OUT_DTYPES.index(out_dtype),
        tile_m(dev, B, Ho, Wo, O, patch=in_type != 0 and k == 3),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_lib.check(status, what)
    conv_int8_cuda.launches += 1
    return out.permute(0, 3, 1, 2)


def conv_int8_cuda(xq: torch.Tensor, w_packed: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor | None, k: int,
                   stride: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel 4's int8 mode on CUDA tensors (one launch). Raises on a bad
    input or a launch error. out_dtype=torch.int32 writes the int32 sums
    (no epilogue), for checking the kernel's reduction alone.

    conv_int8_cuda.launches counts the launches of both modes."""
    _check(xq, w_packed, scale, bias, k, stride, out_dtype)
    if not xq.is_contiguous() or xq.data_ptr() % 16:
        raise ValueError("conv_int8_cuda: a contiguous, 16-byte aligned xq")
    Cp = xq.shape[-1]
    return _launch(xq.permute(0, 3, 1, 2), 0, None, Cp, Cp, w_packed, scale,
                   bias, k, stride, out_dtype, "conv_int8_cuda")


conv_int8_cuda.launches = 0


def pixel_stride(x: torch.Tensor) -> int | None:
    """The pixel stride of x [B, C, H, W] when its memory is NHWC with
    channel stride 1 (channels_last, or a channel slice of a wider such
    tensor), else None: the layouts Kernel 4's float mode reads."""
    B, C, H, W = x.shape
    sB, sC, sH, sW = x.stride()
    ps = sW if W > 1 else sH if H > 1 else sB if B > 1 else C
    ok = ((C == 1 or sC == 1) and ps >= C and (H == 1 or sH == W * ps)
          and (B == 1 or sB == H * W * ps))
    return ps if ok else None


def _check_w8a8(x, s_x, w_packed, scale, bias, k, stride, out_dtype):
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise TypeError("conv_w8a8: x bf16 or float32 [B, C, H, W]")
    if s_x.dtype != torch.float32 or s_x.dim() != 0 \
            or s_x.device != x.device:
        raise ValueError("conv_w8a8: s_x a 0-d float32 tensor on x's device")
    _check_weights(padded(x.shape[1], C_ALIGN), w_packed, scale, bias, k,
                   stride, out_dtype)


def conv_w8a8_cuda(x: torch.Tensor, s_x: torch.Tensor,
                   w_packed: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor | None, k: int, stride: int,
                   out_dtype=None) -> torch.Tensor:
    """Kernel 4's float mode on CUDA tensors: x quantised in the kernel's
    load (one launch, no other operation). Raises on a bad input or a
    launch error; x must be NHWC in memory (pixel_stride)."""
    out_dtype = out_dtype or x.dtype
    _check_w8a8(x, s_x, w_packed, scale, bias, k, stride, out_dtype)
    ps = pixel_stride(x)
    if ps is None:
        raise ValueError(f"conv_w8a8_cuda: x with strides {x.stride()} is "
                         "not NHWC with channel stride 1")
    return _launch(x, _IN_DTYPES.index(x.dtype), s_x, ps, x.shape[1],
                   w_packed, scale, bias, k, stride, out_dtype,
                   "conv_w8a8_cuda")


def conv_w8a8(x: torch.Tensor, s_x: torch.Tensor, w_packed: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor | None, k: int,
              stride: int, out_dtype=None) -> torch.Tensor:
    """The w8a8 convolution of a float activation x [B, C, H, W] with the
    calibrated scale s_x: Kernel 4 (quantising in its load) for a CUDA
    tensor, the plain version for a CPU tensor. Out in x's dtype unless
    out_dtype (torch.int32: the sums)."""
    if x.is_cuda:
        return conv_w8a8_cuda(x, s_x, w_packed, scale, bias, k, stride,
                              out_dtype)
    if x.device.type != "cpu":
        raise ValueError(f"conv_w8a8: unsupported device {x.device}")
    _check_w8a8(x, s_x, w_packed, scale, bias, k, stride,
                out_dtype or x.dtype)
    return conv_w8a8_plain(x, s_x, w_packed, scale, bias, k, stride,
                           out_dtype)


@torch.library.custom_op("posebyte::conv_w8a8", mutates_args=())
def conv_w8a8_op(x: torch.Tensor, s_x: torch.Tensor, w_packed: torch.Tensor,
                 scale: torch.Tensor, bias: torch.Tensor, k: int,
                 stride: int) -> torch.Tensor:
    """conv_w8a8 as the operator torch.ops.posebyte.conv_w8a8, which
    torch.export records in a graph as one node (a ctypes launch cannot be
    traced): Kernel 4 for a CUDA tensor, the plain version for a CPU
    tensor, through the dispatcher. models/aot.py's exported program calls
    it; the eager forward calls conv_w8a8 directly. A graph may hand it an
    activation in another layout than the eager forward's; that one is
    copied to channels_last first, which Kernel 4 reads. Registering it
    builds nothing and touches no device."""
    if x.is_cuda and pixel_stride(x) is None:
        x = x.contiguous(memory_format=torch.channels_last)
    return conv_w8a8(x, s_x, w_packed, scale, bias, k, stride)


@conv_w8a8_op.register_fake
def _(x, s_x, w_packed, scale, bias, k, stride):
    B, _, H, W = x.shape
    return x.new_empty((B, scale.shape[0], _out_size(H, k, stride),
                        _out_size(W, k, stride))).contiguous(
        memory_format=torch.channels_last)


def conv_int8(xq: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor | None, k: int, stride: int,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """The int8 convolution: Kernel 4 for a CUDA tensor, the plain version
    for a CPU tensor."""
    if xq.is_cuda:
        return conv_int8_cuda(xq, w_packed, scale, bias, k, stride,
                              out_dtype)
    if xq.device.type != "cpu":
        raise ValueError(f"conv_int8: unsupported device {xq.device}")
    return conv_int8_plain(xq, w_packed, scale, bias, k, stride, out_dtype)


def _check_depthwise(x, s_x, w, dq, bias):
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 4:
        raise TypeError("conv_w8a8_depthwise: x bf16 or float32 [B, C, H, "
                        "W]")
    if s_x.dtype != torch.float32 or s_x.dim() != 0 \
            or s_x.device != x.device:
        raise ValueError("conv_w8a8_depthwise: s_x a 0-d float32 tensor on "
                         "x's device")
    C = x.shape[1]
    if w.dtype != torch.float32 or w.dim() != 4 or w.shape[:2] != (C, 1) \
            or w.shape[2] != w.shape[3] or w.shape[2] % 2 == 0:
        raise TypeError(f"conv_w8a8_depthwise: float32 weights [{C}, 1, k, "
                        f"k] holding int8 values, got {tuple(w.shape)} "
                        f"{w.dtype}")
    for name, t in (("dq", dq), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (C,):
            raise TypeError(f"conv_w8a8_depthwise: {name} float32 [{C}]")


def _depthwise_epilogue(acc, dq, bias, dtype):
    """The w8a8 epilogue on the sums acc [B, C, Ho, Wo] (float32 or
    float64 holding integers): float32(acc) * dq, then + bias, then one
    rounding to dtype; channels_last."""
    y = acc.float() * dq[:, None, None]
    y = y + bias[:, None, None]
    return y.to(dtype).contiguous(memory_format=torch.channels_last)


def conv_w8a8_depthwise(x: torch.Tensor, s_x: torch.Tensor,
                        w: torch.Tensor, dq: torch.Tensor, bias: torch.Tensor,
                        stride: int = 1) -> torch.Tensor:
    """The depthwise w8a8 conv of YOLO11 (the JAX package's int8 conv with
    feature_group_count = C): x [B, C, H, W] quantised with s_x by the rule
    of quantize_activation, convolved per channel with the int8 weights w
    (their values as float32 [C, 1, k, k]) in float32, then the w8a8
    epilogue (dq = float32(s_x * s_w) [C], the bias), out in x's dtype.

    The float32 conv is exact: each output sums k * k products of two
    integers of magnitude at most 127, below 9 * 127^2 < 2^24 for k = 3,
    as long as the library's algorithm multiplies and adds the values
    themselves (a Winograd or FFT transform would not be exact; on the
    card the result is held against conv_w8a8_depthwise_plain bit for
    bit). Runs on x's device, the CPU or the card (cuDNN: a library conv,
    no Pallas kernel stands behind the JAX function)."""
    _check_depthwise(x, s_x, w, dq, bias)
    k = w.shape[-1]
    acc = F.conv2d(_quantized(x, s_x), w, stride=stride, padding=k // 2,
                   groups=x.shape[1])
    return _depthwise_epilogue(acc, dq, bias, x.dtype)


def conv_w8a8_depthwise_plain(x: torch.Tensor, s_x: torch.Tensor,
                              w: torch.Tensor, dq: torch.Tensor,
                              bias: torch.Tensor, stride: int = 1,
                              out_dtype=None) -> torch.Tensor:
    """conv_w8a8_depthwise's plain version: the integer sums by a float64
    depthwise conv (exact in any order), then the same epilogue;
    out_dtype=torch.int32 returns the sums themselves."""
    _check_depthwise(x, s_x, w, dq, bias)
    k = w.shape[-1]
    acc = F.conv2d(_quantized(x, s_x).double(), w.double(), stride=stride,
                   padding=k // 2, groups=x.shape[1])
    if out_dtype == torch.int32:
        return acc.to(torch.int32).contiguous(
            memory_format=torch.channels_last)
    return _depthwise_epilogue(acc, dq, bias, out_dtype or x.dtype)

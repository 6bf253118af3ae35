"""The int8 convolution of the w8a8 path: Kernel 4's wrapper, its plain
version, the activation quantisation that feeds it and the weight packing
it reads. After posebyte_tpu/ops/pallas_conv.py (conv3x3_int8_pallas) and
the act_scale branch of posebyte_tpu/models/layers.py::conv2d.

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

conv_int8 launches Kernel 4 (csrc/conv_int8.cu) for a CUDA tensor and runs
the plain version for a CPU tensor. The plain version is exact: every
product of two int8 values and every partial sum of a convolution (at most
9 * Cp * 127^2, far below 2^53) is an integer that float64 holds exactly,
so a float64 convolution in any summation order gives the int32 sums.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_lib

C_ALIGN = 32     # input channels padded to a multiple (Kernel 4's step)
O_ALIGN = 64     # output channels of the packed weights (its block width)
SHAPES = ((3, 1), (3, 2), (1, 1))    # (k, stride) Kernel 4 instantiates
_OUT_DTYPES = (torch.bfloat16, torch.float32, torch.int32)


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
    q = torch.clamp(torch.round(x.float() / s_x), -127, 127).to(torch.int8)
    out = torch.zeros((B, H, W, padded(C, C_ALIGN)), dtype=torch.int8,
                      device=x.device)
    out[..., :C] = q.permute(0, 2, 3, 1)
    return out


def _check(xq, w_packed, scale, bias, k, stride, out_dtype):
    if xq.dtype != torch.int8 or w_packed.dtype != torch.int8:
        raise TypeError("conv_int8: int8 activations and weights")
    if xq.dim() != 4 or w_packed.dim() != 3:
        raise ValueError("conv_int8: xq [B, H, W, Cp], w [Op, k * k, Cp]")
    if (k, stride) not in SHAPES or w_packed.shape[1] != k * k:
        raise ValueError(f"conv_int8: (k, stride) = ({k}, {stride}) with "
                         f"weights {tuple(w_packed.shape)}")
    Cp, O = xq.shape[-1], scale.shape[0]
    if w_packed.shape[2] != Cp or Cp % C_ALIGN \
            or w_packed.shape[0] % O_ALIGN or w_packed.shape[0] < O:
        raise ValueError(f"conv_int8: xq {tuple(xq.shape)} and weights "
                         f"{tuple(w_packed.shape)} are not padded alike")
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


def conv_int8_cuda(xq: torch.Tensor, w_packed: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor | None, k: int,
                   stride: int, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Kernel 4 on CUDA tensors (one launch). Raises on a bad input or a
    launch error. out_dtype=torch.int32 writes the int32 sums (no
    epilogue), for checking the kernel's reduction alone."""
    _check(xq, w_packed, scale, bias, k, stride, out_dtype)
    dev = xq.device
    tensors = [xq, w_packed, scale] + ([] if bias is None else [bias])
    if not all(t.is_cuda and t.device == dev and t.is_contiguous()
               for t in tensors):
        raise ValueError("conv_int8_cuda: contiguous inputs on one CUDA "
                         "device")
    if xq.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("conv_int8_cuda: inputs must be 16-byte aligned")
    B, H, W, Cp = xq.shape
    O = scale.shape[0]
    Ho, Wo = _out_size(H, k, stride), _out_size(W, k, stride)
    out = torch.empty((B, Ho, Wo, O), dtype=out_dtype, device=dev)
    lib = cuda_lib.load()
    status = lib.posebyte_conv_int8(
        xq.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), B, H, W,
        Cp, O, w_packed.shape[0], k, stride,
        _OUT_DTYPES.index(out_dtype),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    cuda_lib.check(status, "conv_int8_cuda")
    conv_int8_cuda.launches += 1
    return out.permute(0, 3, 1, 2)


conv_int8_cuda.launches = 0


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


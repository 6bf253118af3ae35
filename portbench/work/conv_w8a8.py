"""The work of one w8a8 convolution (Kernel 4, ops/conv_int8.py), from its
shapes: the bf16 activation [B, H, W, C] read once, the int8 weights
[k, k, C / groups, O] read once, the float32 dequantisation scale and bias
[O] read once, the bf16 output [B, Ho, Wo, O] written once; a multiply and
an add per tap, input channel and output element, at the int8 rate."""
from __future__ import annotations


def work(cin: int, cout: int, k: int, groups: int, hw_in: int, hw_out: int,
         batch: int = 1):
    nbytes = (2 * batch * hw_in * hw_in * cin + k * k * (cin // groups) * cout
              + 8 * cout + 2 * batch * hw_out * hw_out * cout)
    ops = 2 * batch * hw_out * hw_out * cout * (cin // groups) * k * k
    return nbytes, ops

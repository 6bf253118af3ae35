"""Kernel 4's plain versions (both modes), the activation quantisation and
the port's conv2d in its three parameter flavours
(posebyte_tpu_torch/ops/conv_int8.py, models/layers.py) against the JAX
package: lax.conv_general_dilated with int32 accumulation,
conv3x3_int8_pallas in interpret mode, and posebyte_tpu.models.layers.conv2d
(its w8a8 branch for the float-input entry conv_w8a8).

Tolerances: none for the int8 convolution (int32 sums, float32 and bf16
outputs bit for bit), for conv_w8a8 and for the quantisation (ties
included); the float
and weight-only flavours, which both packages leave to their library's
convolution, within 2e-6 of the output's largest magnitude in float32
(summation order; 3e-7 measured) and within one bf16 step (2^-7 relative)
of it in bf16 (XLA rounds the conv and the bias add apart, PyTorch fuses
them).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from posebyte_tpu.models import layers as JL
from posebyte_tpu.ops.pallas_conv import conv3x3_int8_pallas

from posebyte_tpu_torch.models import layers as L
from posebyte_tpu_torch.ops import conv_int8 as CI

torch.set_num_threads(2)


def _case(seed, B, H, W, C, O, k):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (B, H, W, C)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, k, C, O)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, O).astype(np.float32)
    bias = rng.normal(0, 1, O).astype(np.float32)
    return xq, wq, scale, bias


def _port_inputs(xq, wq, scale):
    x = torch.from_numpy(xq).permute(0, 3, 1, 2).float()   # exact integers
    return (CI.quantize_activation(x, torch.tensor(1.0)),
            CI.pack_weights(np.transpose(wq, (3, 2, 0, 1))),
            torch.from_numpy(scale))


def _xla_sums(xq, wq, k, stride):
    pad = k // 2
    return lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("k,stride", CI.SHAPES)
@pytest.mark.parametrize("C,O", [(32, 32), (51, 51), (64, 1), (128, 128)])
def test_plain_matches_xla_int8_conv(k, stride, C, O):
    """The int32 sums and both epilogues (scale only; scale and bias, in
    float32 and bf16) equal XLA's int8 convolution bit for bit, at ragged
    channel counts (51, 1) and an odd spatial size."""
    xq, wq, scale, bias = _case(C * 7 + O, 2, 9, 7, C, O, k)
    x, w, sc = _port_inputs(xq, wq, scale)
    assert x.shape[-1] % CI.C_ALIGN == 0 and w.shape[0] % CI.O_ALIGN == 0
    acc = _xla_sums(xq, wq, k, stride)
    got = CI.conv_int8(x, w, sc, None, k, stride, out_dtype=torch.int32)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(acc))
    y = acc.astype(jnp.float32) * jnp.asarray(scale)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = CI.conv_int8(x, w, sc, None, k, stride, out_dtype=dtype)
        np.testing.assert_array_equal(
            _nhwc(got), np.asarray(y.astype(jdtype), np.float32))
        got = CI.conv_int8(x, w, sc, torch.from_numpy(bias), k, stride,
                           out_dtype=dtype)
        want = (y + jnp.asarray(bias)).astype(jdtype)
        np.testing.assert_array_equal(_nhwc(got),
                                      np.asarray(want, np.float32))


def test_plain_matches_pallas_kernel():
    """At the shape of the JAX kernel's own test
    (tests/test_pallas_kernels.py::test_conv3x3_int8_pallas_matches_xla):
    conv3x3_int8_pallas in interpret mode, bf16 bit for bit."""
    rng = np.random.default_rng(0)
    B, H, W, C, O = 2, 8, 8, 128, 128
    xq = rng.integers(-127, 128, (B, H, W, C)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, 3, C, O)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, O).astype(np.float32)
    want = conv3x3_int8_pallas(jnp.asarray(xq), jnp.asarray(wq),
                               jnp.asarray(scale), interpret=True)
    got = CI.conv_int8(*_port_inputs(xq, wq, scale), None, 3, 1)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want, np.float32))


def test_quantize_activation_matches_jax_with_ties():
    """clamp(round(x / s_x)) with round half to even, as the JAX w8a8
    branch computes it, on values exactly at (n + 0.5) * s_x, beyond the
    clamp and of both signs; the padded channels are zero."""
    rng = np.random.default_rng(3)
    s_x = np.float32(0.05)
    B, C, H, W = 2, 51, 5, 6
    n = rng.integers(-140, 140, (B, C, H, W)).astype(np.float32)
    x = ((n + np.float32(0.5)) * s_x).astype(np.float32)
    x[:, ::3] = rng.normal(0, 4, x[:, ::3].shape)
    ties = np.round(x / s_x) != np.floor(x / s_x + np.float32(0.5))
    assert ties.sum() > 100                     # half-even rounding shows
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype).contiguous(
            memory_format=torch.channels_last)
        xj = jnp.asarray(xt.float().numpy())
        want = np.asarray(jnp.clip(jnp.round(xj / s_x), -127, 127)
                          .astype(jnp.int8))
        got = CI.quantize_activation(xt, torch.tensor(s_x))
        assert got.shape == (B, H, W, 64) and got.dtype == torch.int8
        np.testing.assert_array_equal(got[..., :C].numpy(),
                                      np.transpose(want, (0, 2, 3, 1)))
        assert not got[..., C:].any()


def _jax_conv(p, x, stride, dtype):
    return np.asarray(JL.conv2d(p, jnp.asarray(x).astype(dtype), stride)
                      .astype(jnp.float32))


@pytest.mark.parametrize("flavour", ["float", "weight_only", "w8a8"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("k,stride", CI.SHAPES)
def test_conv2d_flavours_match_jax(flavour, dtype, k, stride):
    """The port's conv2d on prepare_params' tensors against
    posebyte_tpu.models.layers.conv2d on the same parameters: w8a8 bit
    for bit, the float flavours within the stated tolerance."""
    rng = np.random.default_rng(k * 10 + stride)
    C, O = 51, 64
    x = rng.normal(0, 1, (2, 10, 10, C)).astype(np.float32)
    w = rng.normal(0, 0.1, (k, k, C, O)).astype(np.float32)
    b = rng.normal(0, 0.1, O).astype(np.float32)
    jp = {"w": w, "b": b}
    if flavour != "float":
        amax = np.abs(w).max(axis=(0, 1, 2))
        scale = (amax / 127.0).astype(np.float32)
        jp = {"w": np.clip(np.round(w / scale), -127, 127).astype(np.int8),
              "scale": scale, "b": b}
        if flavour == "w8a8":
            jp["act_scale"] = np.asarray(0.02, np.float32)
    flat = {f"c.{n}": (np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v)
            for n, v in jp.items()}
    jdtype = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    want = _jax_conv({n: jnp.asarray(v) for n, v in jp.items()}, x, stride,
                     jdtype)
    p = L.prepare_params(flat, tdtype, "cpu")
    assert ("c.wq" in p) == (flavour == "w8a8")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdtype)
    got = L.conv2d(p, "c", xt, stride)
    assert got.dtype == tdtype
    got = _nhwc(got)
    if flavour == "w8a8":
        np.testing.assert_array_equal(got, want)
    else:
        tol = 2e-6 if dtype == "fp32" else 2.0 ** -7
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= tol * scale


def test_wrapper_refuses_what_the_kernel_does_not_take():
    xq, wq, scale, _ = _case(0, 1, 4, 4, 32, 32, 3)
    x, w, sc = _port_inputs(xq, wq, scale)
    with pytest.raises(ValueError):
        CI.conv_int8(x, w, sc, None, 5, 1)               # no such shape
    with pytest.raises(ValueError):
        CI.conv_int8(x[..., :16].contiguous(), w, sc, None, 3, 1)
    with pytest.raises(TypeError):
        CI.conv_int8(x, w, sc.double(), None, 3, 1)
    with pytest.raises(ValueError):
        CI.conv_int8_cuda(x, w, sc, None, 3, 1)          # a CPU tensor


def _w8a8_case(seed, dtype, C, O, k, ps=None, x_off=0, B=2, H=9, W=7):
    """A float activation [B, C, H, W] in dtype and NHWC memory (channels
    x_off .. + C of a tensor of ps channels when given), a third of its
    values exactly on the .5 ties of s_x and some beyond the clamp, and a
    w8a8 parameter set in the JAX layout (HWIO int8 weights)."""
    rng = np.random.default_rng(seed)
    s_x = np.float32(0.04)
    ps = ps or C
    full = rng.normal(0, 3, (B, H, W, ps)).astype(np.float32)
    n = rng.integers(-140, 140, full.shape).astype(np.float32)
    ties = rng.uniform(size=full.shape) < 0.3
    full[ties] = ((n + np.float32(0.5)) * s_x)[ties]
    x = torch.from_numpy(full).to(dtype).permute(0, 3, 1, 2)[
        :, x_off:x_off + C]
    w = rng.integers(-127, 128, (k, k, C, O)).astype(np.int8)
    scale = rng.uniform(0.001, 0.01, O).astype(np.float32)
    b = rng.normal(0, 1, O).astype(np.float32)
    return x, s_x, {"w": w, "scale": scale, "act_scale": s_x, "b": b}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,stride", CI.SHAPES)
@pytest.mark.parametrize("C,ps,x_off", [
    (51, None, 0),       # the keypoint head's ragged width
    (64, None, 0),
    (128, None, 0),
    (32, 64, 32),        # c2f's channel slice y[:, c_h:] of a wider tensor
])
def test_conv_w8a8_matches_jax_w8a8_branch(dtype, k, stride, C, ps, x_off):
    """The float-input entry on the CPU (quantize_activation, then the
    plain int8 convolution) against posebyte_tpu.models.layers.conv2d's
    w8a8 branch on the same values, bit for bit, .5 ties included; the
    output in x's dtype, channels_last."""
    O = 51 if C == 64 else 64
    x, s_x, jp = _w8a8_case(C + k + stride, dtype, C, O, k, ps, x_off)
    assert CI.pixel_stride(x) == (ps or C)
    jdtype = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype]
    xn = x.float().permute(0, 2, 3, 1).numpy()
    ties = np.round(xn / s_x) != np.floor(xn / s_x + np.float32(0.5))
    assert ties.sum() > 20       # half-even rounding shows (bf16 keeps few)
    want = _jax_conv({n: jnp.asarray(v) for n, v in jp.items()}, xn,
                     stride, jdtype)
    got = CI.conv_w8a8(x, torch.tensor(s_x), CI.pack_weights(
        np.transpose(jp["w"], (3, 2, 0, 1))), torch.from_numpy(
        s_x * jp["scale"]), torch.from_numpy(jp["b"]), k, stride)
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(got), want)


def test_conv_w8a8_int32_sums_are_the_quantised_products():
    """out_dtype=torch.int32: the int32 sums of the quantised activation,
    as XLA's int8 convolution gives them."""
    x, s_x, jp = _w8a8_case(5, torch.bfloat16, 51, 64, 3)
    xq = np.clip(np.round(x.float().permute(0, 2, 3, 1).numpy() / s_x),
                 -127, 127).astype(np.int8)
    got = CI.conv_w8a8(x, torch.tensor(s_x), CI.pack_weights(
        np.transpose(jp["w"], (3, 2, 0, 1))), torch.ones(64), None, 3, 2,
        out_dtype=torch.int32)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(_xla_sums(xq, jp["w"], 3, 2)))


def test_pixel_stride_names_the_layouts_the_kernel_reads():
    x = torch.zeros((2, 64, 5, 6)).contiguous(
        memory_format=torch.channels_last)
    assert CI.pixel_stride(x) == 64
    assert CI.pixel_stride(x[:, 32:]) == 64
    assert CI.pixel_stride(x[:1, 16:48, :1, :1]) is not None  # one pixel
    assert CI.pixel_stride(torch.zeros((2, 64, 5, 6))) is None     # NCHW
    assert CI.pixel_stride(x[:, :, ::2]) is None        # every other row


def test_w8a8_wrapper_refuses_what_the_kernel_does_not_take():
    x, s_x, jp = _w8a8_case(1, torch.float32, 51, 64, 3)
    w = CI.pack_weights(np.transpose(jp["w"], (3, 2, 0, 1)))
    sx, sc = torch.tensor(s_x), torch.from_numpy(jp["scale"])
    with pytest.raises(TypeError):
        CI.conv_w8a8(x.double(), sx, w, sc, None, 3, 1)      # float64
    with pytest.raises(TypeError):
        CI.conv_w8a8(x.half(), sx, w, sc, None, 3, 1)        # float16
    with pytest.raises(ValueError):
        CI.conv_w8a8(x, sx[None], w, sc, None, 3, 1)         # s_x not 0-d
    with pytest.raises(ValueError):
        CI.conv_w8a8(x, sx.double(), w, sc, None, 3, 1)
    with pytest.raises(ValueError):
        CI.conv_w8a8(x[:, :20], sx, w, sc, None, 3, 1)       # Cp 32 != 64
    with pytest.raises(ValueError):
        CI.conv_w8a8(x, sx, w, sc, None, 3, 3)               # no such shape
    with pytest.raises(TypeError):
        CI.conv_w8a8(x, sx, w, sc, None, 3, 1, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        CI.conv_w8a8_cuda(x, sx, w, sc, None, 3, 1)          # a CPU tensor
    with pytest.raises(ValueError):
        CI.conv_w8a8_cuda(x.contiguous(), sx, w, sc, None, 3, 1)   # NCHW


def test_tile_m_fills_the_card_and_prefers_whole_row_patches(monkeypatch):
    """Kernel 4's pixel tile: 128 when a batch of 128 fills the card; at
    one frame the tile that gives the most blocks, and for a 3x3 conv of a
    float input one that holds a whole output row (its patch), at the
    path's widths."""
    monkeypatch.setattr(CI, "_sm_count", lambda index: 132)
    dev = torch.device("cuda")
    for patch in (False, True):
        for Ho, O in ((80, 64), (40, 128), (20, 256)):
            assert CI.tile_m(dev, 128, Ho, Ho, O, patch) == 128
    assert CI.tile_m(dev, 1, 80, 80, 64) == 32             # 200 blocks
    assert CI.tile_m(dev, 1, 80, 80, 64, patch=True) == 128    # 80 rows
    assert CI.tile_m(dev, 1, 40, 40, 64, patch=True) == 64     # 40 rows
    assert CI.tile_m(dev, 1, 20, 20, 128, patch=True) == 32
    assert CI.tile_m(dev, 1, 5, 200, 64, patch=True) == 32     # tap by tap

"""YOLOv8 and YOLO11 building blocks as plain functions on a flat
parameter dict.

Counterparts of posebyte_tpu/models/layers.py (conv2d, conv_block,
dwconv_block, bottleneck, c2f, c3, c3k2, sppf, the C2PSA attention stage,
upsample2x, the calibration recorder; conv2d_s2d, conv_block_s2d and
packed_stem, the JAX package's TPU lane layouts of the plain stem) and
their initialisers (conv_init, dwconv_init, c2f_init, c3_init, c3k2_init,
sppf_init, c2psa_init). Activations are NCHW tensors kept in
channels_last memory, so cuDNN runs its NHWC kernels; weights are OIHW.
BatchNorm is already fused into every conv. Padding is torch-style
symmetric k//2.

A checkpoint's conv comes in one of three flavours (the JAX conv2d's):
float {w, b}; weight-only int8 {w int8, scale, b}; w8a8 {w int8, scale,
act_scale, b}. prepare_params turns them into what conv2d runs: the first
two as a float conv (the int8 weights dequantised once, as
w.to(dtype) * scale.to(dtype)), the third as Kernel 4's packed weights, or,
for a depthwise conv (is_depthwise), as float32 weights holding the int8
values for ops.conv_int8.conv_w8a8_depthwise (Kernel 4 has no grouped mode).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.conv_int8 import (conv_w8a8, conv_w8a8_depthwise, conv_w8a8_op,
                             pack_weights)

# Active calibration recorder (models/quant.py sets a CalibrationRecorder
# while it runs the forward eagerly; None otherwise).
_CALIBRATION_RECORDER = None
# True while models/aot.py traces the forward with torch.export: the w8a8
# convs then go through the registered operator posebyte::conv_w8a8
# (ops.conv_int8.conv_w8a8_op), which the exported graph records, instead
# of the ctypes launch.
_EXPORTING = False


class _EntropyHist:
    """Streaming |activation| histogram with a growable range (2048 bins),
    after posebyte_tpu/models/layers.py::_EntropyHist: when a batch exceeds
    the current range the bin width doubles and adjacent bins merge, so
    one pass over the calibration set suffices."""
    NBINS = 2048

    def __init__(self):
        self.counts = np.zeros(self.NBINS, np.int64)
        self.width = 0.0

    def update(self, absx: np.ndarray):
        if absx.size == 0:
            return
        amax = float(absx.max())
        if amax == 0.0:
            return
        if self.width == 0.0:
            self.width = amax / self.NBINS
        while amax > self.NBINS * self.width:
            merged = self.counts[0::2] + self.counts[1::2]
            self.counts = np.concatenate(
                [merged, np.zeros(self.NBINS // 2, np.int64)])
            self.width *= 2.0
        idx = np.minimum((absx / self.width).astype(np.int64),
                         self.NBINS - 1)
        self.counts += np.bincount(idx, minlength=self.NBINS) \
            .astype(np.int64)


def percentile_999(absx: torch.Tensor) -> float:
    """jnp.percentile(absx, 99.9) (linear interpolation) for any size
    (torch.quantile refuses inputs above 2^24 elements), with JAX's float32
    arithmetic: q = float32(99.9) / 100, position q * (n - 1), the two
    neighbouring order statistics weighted by its fraction."""
    flat = absx.reshape(-1).float()
    n = np.float32(flat.numel())
    pos = (np.float32(99.9) / np.float32(100)) * (n - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = pos - lo
    w_lo = np.float32(1) - w_hi
    v = torch.sort(flat).values[[int(lo), int(hi)]].cpu().numpy()
    return float(v[0] * w_lo + v[1] * w_hi)


class CalibrationRecorder:
    """What calibration records of the convs it names: per conv key, None
    until the conv runs, then for method "percentile" the list of each
    batch's 99.9th percentile of |x|, for "entropy" a streaming |x|
    histogram (models/quant.py::_kl_threshold reads it)."""

    def __init__(self, keys, method: str):
        self.method = method
        self.records = dict.fromkeys(keys)

    def record(self, key: str, x: torch.Tensor):
        if key not in self.records:
            return
        if self.method == "entropy":
            if self.records[key] is None:
                self.records[key] = _EntropyHist()
            self.records[key].update(x.float().abs().cpu().numpy().ravel())
        else:
            if self.records[key] is None:
                self.records[key] = []
            self.records[key].append(percentile_999(x.float().abs()))


def is_depthwise(key: str) -> bool:
    """Whether the conv `key` is depthwise, decided by its place in the
    model as the JAX package decides it by call site: YOLO11's head convs
    "head.cv3.{i}.{j}_dw" and the attention's positional conv "...attn.pe".
    """
    return key.endswith("_dw") or key.endswith(".attn.pe")


def prepare_params(params: dict, dtype: torch.dtype, device) -> dict:
    """A checkpoint's flat dict (numpy or tensors, models.load_params) ->
    the tensors conv2d runs on, on `device`:
    - float and weight-only int8 convs: "w" in `dtype` (channels_last) and
      "b" in `dtype`; weight-only weights are dequantised here once, as
      w.to(dtype) * scale.to(dtype) (the JAX conv2d does it per call);
    - w8a8 convs: "wq" Kernel 4's packed int8 weights, "dq" the dequant
      factor float32(act_scale * scale) [O], "act_scale" a 0-d float32
      tensor on the device (the quantisation divides by it), "b"
      float32; a depthwise w8a8 conv has "wdw", its int8 weights [C, 1,
      k, k] as float32 values, in place of "wq"."""
    out = {}
    for key in params:
        if not key.endswith(".w"):
            continue
        p = key[:-2]
        w = torch.as_tensor(np.asarray(params[key]))
        b = torch.as_tensor(np.asarray(params[p + ".b"], np.float32))
        if p + ".act_scale" in params:
            s_x = np.asarray(params[p + ".act_scale"], np.float32)
            scale = np.asarray(params[p + ".scale"], np.float32)
            if is_depthwise(p):
                out[p + ".wdw"] = w.to(device, torch.float32)
            else:
                out[p + ".wq"] = pack_weights(w).to(device)
            out[p + ".dq"] = torch.from_numpy(
                np.ascontiguousarray(s_x * scale)).to(device)
            out[p + ".act_scale"] = torch.from_numpy(s_x).to(device)
            out[p + ".b"] = b.to(device)
            continue
        if p + ".scale" in params:
            scale = torch.as_tensor(np.asarray(params[p + ".scale"],
                                               np.float32))
            w = w.to(dtype) * scale.to(dtype)[:, None, None, None]
        out[key] = w.to(device, dtype).contiguous(
            memory_format=torch.channels_last)
        out[p + ".b"] = b.to(device, dtype)
    return out


def conv2d(p: dict, key: str, x: torch.Tensor, stride: int = 1,
           groups: int = 1):
    """Conv with bias on prepare_params' tensors: a float conv (cuDNN on
    the card) for p[key + ".w"] [O, I / groups, k, k], or the w8a8 conv
    for p[key + ".wq"]: x quantised to int8 with the calibrated scale and
    convolved, on the card in one Kernel 4 launch, out in x's dtype; or
    for p[key + ".wdw"] the depthwise w8a8 conv (groups = channels)."""
    if _CALIBRATION_RECORDER is not None:
        _CALIBRATION_RECORDER.record(key, x)
    wq = p.get(key + ".wq")
    if wq is not None:
        k = round(wq.shape[1] ** 0.5)
        conv = conv_w8a8_op if _EXPORTING else conv_w8a8
        return conv(x, p[key + ".act_scale"], wq, p[key + ".dq"],
                    p[key + ".b"], k, stride)
    wdw = p.get(key + ".wdw")
    if wdw is not None:
        if groups != x.shape[1]:
            raise ValueError(f"{key}: a depthwise w8a8 conv needs groups "
                             f"= channels, got {groups}")
        return conv_w8a8_depthwise(x, p[key + ".act_scale"], wdw,
                                   p[key + ".dq"], p[key + ".b"], stride)
    w = p[key + ".w"]
    return F.conv2d(x, w, p[key + ".b"], stride=stride,
                    padding=w.shape[-1] // 2, groups=groups)


def conv_block(p: dict, key: str, x: torch.Tensor, stride: int = 1):
    """Conv + (folded) BN + SiLU: ultralytics `Conv`."""
    return F.silu(conv2d(p, key, x, stride))


def _float_weights(p: dict, key: str) -> torch.Tensor:
    w = p.get(key + ".w")
    if w is None:
        raise ValueError(f"{key}: a float (or weight-only int8) conv is "
                         "needed here, not a w8a8 one")
    return w


def conv2d_s2d(p: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """A 3x3 stride-2 conv (torch padding 1) in its exact space-to-depth
    form, after posebyte_tpu/models/layers.py:155-199: each 2x2 pixel cell
    of x [B, C, H, W] (H, W even) becomes 4C channels, ordered (py * 2 +
    px) * C + c, and the 3x3 kernel a 2x2 stride-1 kernel over cells with
    one cell of padding at the top and left (tap dy lands in cell row
    y - 1, py = 1 for dy = 0, else row y, py = dy - 1; the same along x).
    The same products and sums as conv2d(p, key, x, 2), which the JAX
    package packs for the TPU's lanes; on float or weight-only int8
    weights (prepare_params dequantised those)."""
    w = _float_weights(p, key)                        # [O, C, 3, 3]
    if w.shape[-2:] != (3, 3):
        raise ValueError(f"{key}: conv2d_s2d needs a 3x3 kernel")
    B, C, H, W = x.shape
    O = w.shape[0]
    x2 = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4) \
        .reshape(B, 4 * C, H // 2, W // 2)
    w2 = w.new_zeros((O, 4 * C, 2, 2))
    for dy in range(3):
        cy, py = (0, 1) if dy == 0 else (1, dy - 1)
        for dx in range(3):
            cx, px = (0, 1) if dx == 0 else (1, dx - 1)
            ch = (py * 2 + px) * C
            w2[:, ch:ch + C, cy, cx] = w[:, :, dy, dx]
    return F.conv2d(F.pad(x2, (1, 0, 1, 0)), w2, p[key + ".b"])


def conv_block_s2d(p: dict, key: str, x: torch.Tensor) -> torch.Tensor:
    """SiLU(conv2d_s2d): conv_block(p, key, x, 2) in its space-to-depth
    form."""
    return F.silu(conv2d_s2d(p, key, x))


def packed_stem(p: dict, key0: str, key1: str, x: torch.Tensor,
                pack: int) -> torch.Tensor:
    """The first two stride-2 Conv + SiLU layers of `pack` frames at once,
    after posebyte_tpu/models/layers.py:207-247: x [B, C, S, S] with B
    divisible by pack -> [B, c1, S / 4, S / 4], equal to
    conv_block(p, key1, conv_block(p, key0, x, 2), 2).

    The JAX package puts P frames' channels side by side with
    block-diagonal weights to fill the TPU's 128 lanes; here the same
    packing is one grouped conv (groups = P, each group one frame's
    channels and the conv's own weights), so no frame reads another's
    channels and every output sums the products of its own frame: exact
    per frame in float32, up to the convolution's order of summation.
    Float stems only (int8 keeps the stem in float, PARTIAL_QUANT_SKIP).
    The output is channels_last, as the plain stem's."""
    B, C, S, _ = x.shape
    P = pack
    if B % P:
        raise ValueError(f"packed_stem: batch {B} is not a multiple of {P}")
    y = x.reshape(B // P, P * C, S, S)
    for key in (key0, key1):
        w = _float_weights(p, key)
        y = F.silu(F.conv2d(y, w.repeat(P, 1, 1, 1), p[key + ".b"].repeat(P),
                            stride=2, padding=w.shape[-1] // 2, groups=P))
    c1 = y.shape[1] // P
    return y.reshape(B, c1, *y.shape[2:]).contiguous(
        memory_format=torch.channels_last)


def dwconv_block(p: dict, key: str, x: torch.Tensor, stride: int = 1):
    """Depthwise conv + SiLU: ultralytics `DWConv` (YOLO11's heads)."""
    return F.silu(conv2d(p, key, x, stride, groups=x.shape[1]))


def bottleneck(p: dict, key: str, x: torch.Tensor, add: bool):
    y = conv_block(p, key + ".cv2", conv_block(p, key + ".cv1", x))
    return x + y if add else y


def c2f(p: dict, key: str, x: torch.Tensor, shortcut: bool):
    """CSP bottleneck with 2 convs and n inner bottlenecks (ultralytics
    C2f); n is the number of bottlenecks the checkpoint holds."""
    y = conv_block(p, key + ".cv1", x)
    c_h = y.shape[1] // 2
    parts = [y[:, :c_h], y[:, c_h:]]
    i = 0
    while f"{key}.m.{i}.cv1.b" in p:
        parts.append(bottleneck(p, f"{key}.m.{i}", parts[-1], shortcut))
        i += 1
    return conv_block(p, key + ".cv2", torch.cat(parts, dim=1))


def c3(p: dict, key: str, x: torch.Tensor):
    """CSP bottleneck with 3 convs (ultralytics C3; YOLO11's C3k with
    3x3 bottlenecks): cv1 and cv2 both read x, the bottlenecks (always
    with the shortcut, c_h -> c_h) follow cv1."""
    a = conv_block(p, key + ".cv1", x)
    i = 0
    while f"{key}.m.{i}.cv1.b" in p:
        a = bottleneck(p, f"{key}.m.{i}", a, True)
        i += 1
    b = conv_block(p, key + ".cv2", x)
    return conv_block(p, key + ".cv3", torch.cat([a, b], dim=1))


def c3k2(p: dict, key: str, x: torch.Tensor):
    """YOLO11's C3k2: a C2f whose inner blocks are C3k (a C3 of 3x3
    bottlenecks) or bottlenecks (hidden width c_h / 2), both with the
    shortcut. The JAX tree holds inner block i as a (kind, params) tuple,
    so its parameters sit under "m.{i}.1."; it is a C3k where it has a
    cv3."""
    y = conv_block(p, key + ".cv1", x)
    c_h = y.shape[1] // 2
    parts = [y[:, :c_h], y[:, c_h:]]
    i = 0
    while f"{key}.m.{i}.1.cv1.b" in p:
        m = f"{key}.m.{i}.1"
        parts.append(c3(p, m, parts[-1]) if m + ".cv3.b" in p
                     else bottleneck(p, m, parts[-1], True))
        i += 1
    return conv_block(p, key + ".cv2", torch.cat(parts, dim=1))


def attention(p: dict, key: str, x: torch.Tensor, num_heads: int):
    """Ultralytics `Attention` over the H * W positions of x [B, C, H, W]
    (channels_last memory), after the JAX _attention: qkv's channels
    grouped per head (head h's channels h * (2 kd + hd) + j: its query,
    key, value), scores q . k in float32 times kd ** -0.5 after the
    product, softmax in float32 cast to x's type, attn . v summed in
    float32 and cast to x's type; plus the depthwise positional conv of v;
    then proj. The head count comes from the configuration (qkv's width
    is 2 C for any count)."""
    B, C, H, W = x.shape
    nh = num_heads
    hd = C // nh
    kd = hd // 2
    N = H * W
    qkv = conv2d(p, key + ".qkv", x)                       # [B, 2C, H, W]
    qkv = qkv.permute(0, 2, 3, 1).reshape(B, N, nh, 2 * kd + hd)
    q, k, v = qkv[..., :kd], qkv[..., kd:2 * kd], qkv[..., 2 * kd:]
    attn = torch.einsum("bnhk,bmhk->bhnm", q.float(), k.float()) \
        * kd ** -0.5
    attn = torch.softmax(attn, dim=-1).to(x.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", attn.float(), v.float()) \
        .to(x.dtype).reshape(B, H, W, C).permute(0, 3, 1, 2)
    vv = v.reshape(B, H, W, C).permute(0, 3, 1, 2)
    pe = conv2d(p, key + ".pe", vv, groups=C)
    return conv2d(p, key + ".proj", out + pe)


def psablock(p: dict, key: str, x: torch.Tensor, num_heads: int):
    """PSABlock: x + attention, then x + ffn2(SiLU(ffn1(x)))."""
    x = x + attention(p, key + ".attn", x, num_heads)
    return x + conv2d(p, key + ".ffn2", conv_block(p, key + ".ffn1", x))


def c2psa(p: dict, key: str, x: torch.Tensor):
    """YOLO11's C2PSA: cv1, its second half through the PSA blocks, cv2;
    max(1, c_h // 64) heads, c_h half of cv1's width."""
    y = conv_block(p, key + ".cv1", x)
    c_h = y.shape[1] // 2
    a, b = y[:, :c_h], y[:, c_h:]
    i = 0
    while f"{key}.m.{i}.ffn1.b" in p:
        b = psablock(p, f"{key}.m.{i}", b, max(1, c_h // 64))
        i += 1
    return conv_block(p, key + ".cv2", torch.cat([a, b], dim=1))


def sppf(p: dict, key: str, x: torch.Tensor, k: int = 5):
    """Spatial pyramid pooling (fast): 3 chained k x k maxpools, concat."""
    y = conv_block(p, key + ".cv1", x)
    p1 = F.max_pool2d(y, k, 1, k // 2)
    p2 = F.max_pool2d(p1, k, 1, k // 2)
    p3 = F.max_pool2d(p2, k, 1, k // 2)
    return conv_block(p, key + ".cv2", torch.cat([y, p1, p2, p3], dim=1))


def upsample2x(x: torch.Tensor):
    """Nearest-neighbour 2x upsample (ultralytics nn.Upsample)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


# ---------------------------------------------------------------------------
# Initialisation (after posebyte_tpu/models/layers.py:45, :266, :293-458)
# ---------------------------------------------------------------------------
# Each initialiser writes its block's parameters into the flat dict `p`
# under `key`, in the key order and with the shapes (OIHW) and dtypes
# (float32) that params_from_jax gives for the JAX initialiser's tree: He-
# normal weights (std sqrt(2 / fan_in)) drawn from the torch.Generator `g`,
# zero biases. The JAX tree's static leaves (a bottleneck's "add", a
# block's "c_h", SPPF's "k", the attention's head counts) hold no array,
# so they have no key; the forward reads them from the call site.

def conv_init(p: dict, key: str, g: torch.Generator, c_in: int, c_out: int,
              k: int = 1):
    """A conv's He-normal weights [c_out, c_in, k, k] and zero bias."""
    std = math.sqrt(2.0 / (c_in * k * k))
    p[key + ".w"] = (torch.randn((c_out, c_in, k, k), generator=g)
                     * std).numpy()
    p[key + ".b"] = np.zeros((c_out,), np.float32)


def dwconv_init(p: dict, key: str, g: torch.Generator, c: int, k: int = 3):
    """A depthwise conv's He-normal weights [c, 1, k, k] (fan-in k * k)
    and zero bias."""
    std = math.sqrt(2.0 / (k * k))
    p[key + ".w"] = (torch.randn((c, 1, k, k), generator=g) * std).numpy()
    p[key + ".b"] = np.zeros((c,), np.float32)


def bottleneck_init(p, key, g, c_in, c_out, e=0.5, k=(3, 3)):
    c_h = int(c_out * e)
    conv_init(p, key + ".cv1", g, c_in, c_h, k[0])
    conv_init(p, key + ".cv2", g, c_h, c_out, k[1])


def c2f_init(p, key, g, c_in, c_out, n=1, e=0.5):
    c_h = int(c_out * e)
    conv_init(p, key + ".cv1", g, c_in, 2 * c_h, 1)
    conv_init(p, key + ".cv2", g, (2 + n) * c_h, c_out, 1)
    for i in range(n):
        bottleneck_init(p, f"{key}.m.{i}", g, c_h, c_h, e=1.0)


def c3_init(p, key, g, c_in, c_out, n=1, e=0.5, bk=(1, 3)):
    c_h = int(c_out * e)
    conv_init(p, key + ".cv1", g, c_in, c_h, 1)
    conv_init(p, key + ".cv2", g, c_in, c_h, 1)
    conv_init(p, key + ".cv3", g, 2 * c_h, c_out, 1)
    for i in range(n):
        bottleneck_init(p, f"{key}.m.{i}", g, c_h, c_h, e=1.0, k=bk)


def c3k2_init(p, key, g, c_in, c_out, n=1, c3k=False, e=0.5):
    """YOLO11's C3k2: inner block i (a C3k of two 3x3 bottlenecks, or a
    bottleneck of hidden width c_h / 2) under "m.{i}.1", as c3k2 reads
    it."""
    c_h = int(c_out * e)
    conv_init(p, key + ".cv1", g, c_in, 2 * c_h, 1)
    conv_init(p, key + ".cv2", g, (2 + n) * c_h, c_out, 1)
    for i in range(n):
        if c3k:
            c3_init(p, f"{key}.m.{i}.1", g, c_h, c_h, n=2, bk=(3, 3))
        else:
            bottleneck_init(p, f"{key}.m.{i}.1", g, c_h, c_h, e=0.5)


def sppf_init(p, key, g, c_in, c_out):
    c_h = c_in // 2
    conv_init(p, key + ".cv1", g, c_in, c_h, 1)
    conv_init(p, key + ".cv2", g, c_h * 4, c_out, 1)


def _attention_init(p, key, g, dim, num_heads):
    key_dim = dim // num_heads // 2
    conv_init(p, key + ".qkv", g, dim, dim + 2 * key_dim * num_heads, 1)
    conv_init(p, key + ".proj", g, dim, dim, 1)
    dwconv_init(p, key + ".pe", g, dim, 3)


def c2psa_init(p, key, g, c, n=1, e=0.5):
    c_h = int(c * e)
    conv_init(p, key + ".cv1", g, c, 2 * c_h, 1)
    conv_init(p, key + ".cv2", g, 2 * c_h, c, 1)
    for i in range(n):
        m = f"{key}.m.{i}"
        _attention_init(p, m + ".attn", g, c_h, max(1, c_h // 64))
        conv_init(p, m + ".ffn1", g, c_h, 2 * c_h, 1)
        conv_init(p, m + ".ffn2", g, 2 * c_h, c_h, 1)

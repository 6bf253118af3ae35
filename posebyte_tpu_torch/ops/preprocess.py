"""Letterbox preprocessing on the device, after
posebyte_tpu/ops/preprocess.py (letterbox_params :67, _selection_strides
:113, letterbox_flat_nhwc :156-283, letterbox_flat and letterbox_image
:284-304, unletterbox_coords).

Frames arrive as flat u8 bytes [H*W*3], one or a batch [K, H*W*3]. Two
lowerings compute the reference kernel's sampling: src = (t - pad) / scale
clamped to [0, dim - 1.001], two-tap bilinear (preprocess.cu:50-77).
- Matmul (selection=False, the per-frame path): the separable float32
  interpolation Wy @ img @ Wx^T with precomputed matrices. Each row of Wy
  has two taps, so the row stage is computed as its two products and one
  add (no fused multiply-add, as XLA's CPU dot computes it: the bytes
  equal the JAX package's at 1280x720, 1920x1080 and 333x517); the column
  stage is a matmul.
- Selection (selection=True, the chunk path): where every output sample
  lands exactly on an input pixel with one stride per axis (1280x720,
  1920x1080 and 3840x2160 into 640 or 256 are exact decimations), the
  resample is a strided view of the bytes, copied into a gray-114 canvas.
  It returns uint8; the model's input cast converts exactly. Geometries
  that need interpolation take the matmul lowering.
Both give the same values in either of two modes:
- raw=True: BGR order, 0..255 scale, gray-114 padding, with the flip and
  /255 folded into the stem conv (models.weights.fold_stem_preprocess).
- raw=False (the default, the reference kernel's output): RGB order, 0..1
  values, LETTERBOX_PAD_VALUE padding. The matmul lowering folds the 1/255
  into its row matrix; the selection lowering flips the u8 content and
  multiplies by float32(1/255) after the convert.
Not ported, as not applicable: the JAX module's batch1_selection_override
reads an environment variable that switches the per-frame sites to the
selection lowering for TPU A/B probes; here each path has one route.
Likewise ingest_retile_override, which picks between two TPU lowerings of
the selection path's retile; the port's selection is one strided view.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import constants as C

# float32(1/255), the normalised selection lowering's scale (exact in f32,
# so the multiply rounds as the JAX package's float32 multiply does).
_INV_255 = float(np.float32(1.0 / 255.0))


def letterbox_params(input_width: int, input_height: int,
                     target: int = C.DEFAULT_INPUT_SIZE):
    """Letterbox geometry (reference: preprocess.cu:117-127):
    (scale, new_w, new_h, pad_x, pad_y)."""
    scale = min(target / input_width, target / input_height)
    new_w = int(input_width * scale)
    new_h = int(input_height * scale)
    pad_x = (target - new_w) // 2
    pad_y = (target - new_h) // 2
    return scale, new_w, new_h, pad_x, pad_y


@functools.lru_cache(maxsize=16)
def _interp_matrices(input_width: int, input_height: int, target: int,
                     norm: float = 1.0):
    """Separable bilinear weights and content mask as numpy:
    (Wy [target, H] f32 with `norm` folded in, Wx [target, W] f32,
    mask [target, target] bool)."""
    scale, new_w, new_h, pad_x, pad_y = letterbox_params(
        input_width, input_height, target)

    def axis_matrix(n_out, n_in, pad, norm):
        t = np.arange(n_out, dtype=np.float64)
        src = np.clip((t - pad) / scale, 0.0, n_in - 1.001)
        i0 = src.astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        w1 = src - i0
        M = np.zeros((n_out, n_in), np.float32)
        M[np.arange(n_out), i0] += ((1.0 - w1) * norm).astype(np.float32)
        M[np.arange(n_out), i1] += (w1 * norm).astype(np.float32)
        return M

    Wy = axis_matrix(target, input_height, pad_y, norm)
    Wx = axis_matrix(target, input_width, pad_x, 1.0)
    tx = np.arange(target)
    mask = ((tx[None, :] >= pad_x) & (tx[None, :] < pad_x + new_w)
            & (tx[:, None] >= pad_y) & (tx[:, None] < pad_y + new_h))
    return Wy, Wx, mask


@functools.lru_cache(maxsize=16)
def _selection_strides(input_width: int, input_height: int, target: int):
    """((y0, sy), (x0, sx)) when the letterbox is a strided selection on
    both axes (every content sample has fractional weight 0 and the source
    index steps uniformly), else None."""
    scale, new_w, new_h, pad_x, pad_y = letterbox_params(
        input_width, input_height, target)

    def axis_sel(n_in, pad, n_content):
        t = np.arange(target, dtype=np.float64)
        src = np.clip((t - pad) / scale, 0.0, n_in - 1.001)
        i0 = src.astype(np.int64)
        c = slice(pad, pad + n_content)
        if not np.all((src - i0)[c] < 1e-9):
            return None
        idx = i0[c]
        if n_content == 1:
            return int(idx[0]), 1
        steps = np.diff(idx)
        if steps[0] < 1 or not np.all(steps == steps[0]):
            return None
        return int(idx[0]), int(steps[0])

    ysel = axis_sel(input_height, pad_y, new_h)
    xsel = axis_sel(input_width, pad_x, new_w)
    if ysel is None or xsel is None:
        return None
    return ysel, xsel


@functools.lru_cache(maxsize=16)
def _interp_tensors(input_width: int, input_height: int, target: int,
                    norm: float, device: torch.device):
    """The matmul lowering's constants on `device`: the row stage's two
    taps per output row (the source rows i0 then i1 as one index [2 *
    target], their weights, Wy's two entries of each row, as [2, target,
    1]), Wx and the content mask."""
    Wy, Wx, mask = _interp_matrices(input_width, input_height, target, norm)
    scale, _, _, _, pad_y = letterbox_params(input_width, input_height,
                                             target)
    src = np.clip((np.arange(target, dtype=np.float64) - pad_y) / scale,
                  0.0, input_height - 1.001)
    i0 = src.astype(np.int64)
    i1 = np.minimum(i0 + 1, input_height - 1)
    rows = np.arange(target)
    taps = (np.concatenate([i0, i1]),
            np.stack([Wy[rows, i0], Wy[rows, i1]])[..., None])
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in taps + (Wx, mask))


def letterbox_flat_nhwc(frame_flat: torch.Tensor, input_width: int,
                        input_height: int,
                        target: int = C.DEFAULT_INPUT_SIZE,
                        bgr_to_rgb: bool = True,
                        out_dtype=torch.float32,
                        selection: bool = False,
                        raw: bool = False) -> torch.Tensor:
    """Flat u8 BGR frames [..., H*W*3] -> letterboxes [..., target, target,
    3]: with raw=True BGR, 0..255, gray 114 outside the content; else RGB
    (BGR as it came with bgr_to_rgb=False), 0..1, LETTERBOX_PAD_VALUE
    outside the content.

    selection=True takes the strided-selection lowering where the geometry
    allows it; raw, it returns uint8 whatever out_dtype is. Otherwise the
    interpolation runs in float32 (TF32 off, core.set_numeric_settings) and
    out_dtype rounds only the final values, which is the rounding the
    model's own input cast applies."""
    lead = frame_flat.shape[:-1]
    sel = (_selection_strides(input_width, input_height, target)
           if selection else None)
    if sel is not None:
        (y0, sy), (x0, sx) = sel
        _, new_w, new_h, pad_x, pad_y = letterbox_params(
            input_width, input_height, target)
        img = frame_flat.reshape(*lead, input_height, input_width, 3)
        content = img[..., y0:y0 + sy * (new_h - 1) + 1:sy,
                      x0:x0 + sx * (new_w - 1) + 1:sx, :]
        if raw:
            out = torch.full((*lead, target, target, 3),
                             C.LETTERBOX_PAD_RAW, dtype=torch.uint8,
                             device=frame_flat.device)
        else:
            if bgr_to_rgb:              # on the u8 content, before the convert
                content = content.flip(-1)
            content = content.float() * _INV_255
            out = torch.full((*lead, target, target, 3),
                             C.LETTERBOX_PAD_VALUE, dtype=torch.float32,
                             device=frame_flat.device)
        out[..., pad_y:pad_y + new_h, pad_x:pad_x + new_w, :] = content
        return out if raw else out.to(out_dtype)
    taps, w, Wx, mask = _interp_tensors(
        input_width, input_height, target, 1.0 if raw else 1.0 / 255.0,
        frame_flat.device)
    img = frame_flat.reshape(*lead, input_height, input_width * 3)
    # rows: Wy @ img as its two taps, both gathered in one u8 index, each
    # product rounded before the add
    t0, t1 = (w * img.index_select(-2, taps).float().unflatten(
        -2, (2, target))).unbind(-3)
    a = (t0 + t1).reshape(*lead, target, input_width, 3)
    out = torch.einsum("...ywc,xw->...yxc", a, Wx)            # cols
    if raw:
        pad = float(C.LETTERBOX_PAD_RAW)
    else:
        pad = C.LETTERBOX_PAD_VALUE
        if bgr_to_rgb:
            out = out.flip(-1)
    out = torch.where(mask[..., None], out, pad)
    return out.to(out_dtype)


def letterbox_flat(frame_flat: torch.Tensor, input_width: int,
                   input_height: int, target: int = C.DEFAULT_INPUT_SIZE,
                   bgr_to_rgb: bool = True,
                   selection: bool = True) -> torch.Tensor:
    """Flat u8 frames [..., H*W*3] -> float32 [..., 3, target, target]
    normalised CHW letterboxes (the reference kernel's output layout,
    preprocess.cu:19-83)."""
    out = letterbox_flat_nhwc(frame_flat, input_width, input_height, target,
                              bgr_to_rgb, selection=selection)
    return out.movedim(-1, -3)


def letterbox_image(image: torch.Tensor, target: int = C.DEFAULT_INPUT_SIZE,
                    bgr_to_rgb: bool = True) -> torch.Tensor:
    """u8 HWC image -> float32 [3, target, target] normalised letterbox."""
    H, W = image.shape[0], image.shape[1]
    return letterbox_flat(image.reshape(-1), W, H, target, bgr_to_rgb)


def unletterbox_coords(xy: np.ndarray, input_width: int, input_height: int,
                       target: int = C.DEFAULT_INPUT_SIZE) -> np.ndarray:
    """Map [..., 2] model-space coordinates back to frame pixels
    (reference: scaleTrackOutputs, src/main.cpp:48-68)."""
    scale, _, _, pad_x, pad_y = letterbox_params(input_width, input_height,
                                                 target)
    pad = np.asarray([pad_x, pad_y], np.float32)
    return (np.asarray(xy, np.float32) - pad) / np.float32(scale)

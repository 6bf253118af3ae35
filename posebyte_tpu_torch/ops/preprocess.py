"""Letterbox preprocessing on the device, after
posebyte_tpu/ops/preprocess.py (letterbox_params :67, _selection_strides
:113, letterbox_flat_nhwc :156-283, unletterbox_coords).

Frames arrive as flat u8 bytes [H*W*3], one or a batch [K, H*W*3]. Two
lowerings compute the reference kernel's sampling: src = (t - pad) / scale
clamped to [0, dim - 1.001], two-tap bilinear (preprocess.cu:50-77).
- Matmul (selection=False, the per-frame path): two separable float32
  matmuls with precomputed interpolation matrices.
- Selection (selection=True, the chunk path): where every output sample
  lands exactly on an input pixel with one stride per axis (1280x720,
  1920x1080 and 3840x2160 into 640 or 256 are exact decimations), the
  resample is a strided view of the bytes, copied into a gray-114 canvas.
  It returns uint8; the model's input cast converts exactly. Geometries
  that need interpolation take the matmul lowering.
Both give the raw letterbox: BGR order, 0..255 scale, gray-114 padding,
with the flip and /255 folded into the stem conv
(models.weights.fold_stem_preprocess), and the same values.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import constants as C


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
def _interp_matrices(input_width: int, input_height: int, target: int):
    """Separable bilinear weights and content mask as numpy:
    (Wy [target, H] f32, Wx [target, W] f32, mask [target, target] bool)."""
    scale, new_w, new_h, pad_x, pad_y = letterbox_params(
        input_width, input_height, target)

    def axis_matrix(n_out, n_in, pad):
        t = np.arange(n_out, dtype=np.float64)
        src = np.clip((t - pad) / scale, 0.0, n_in - 1.001)
        i0 = src.astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        w1 = src - i0
        M = np.zeros((n_out, n_in), np.float32)
        M[np.arange(n_out), i0] += (1.0 - w1).astype(np.float32)
        M[np.arange(n_out), i1] += w1.astype(np.float32)
        return M

    Wy = axis_matrix(target, input_height, pad_y)
    Wx = axis_matrix(target, input_width, pad_x)
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
                    device: torch.device):
    Wy, Wx, mask = _interp_matrices(input_width, input_height, target)
    return (torch.from_numpy(Wy).to(device), torch.from_numpy(Wx).to(device),
            torch.from_numpy(mask).to(device))


def letterbox_flat_nhwc(frame_flat: torch.Tensor, input_width: int,
                        input_height: int,
                        target: int = C.DEFAULT_INPUT_SIZE,
                        out_dtype=torch.float32,
                        selection: bool = False) -> torch.Tensor:
    """Flat u8 BGR frames [..., H*W*3] -> raw letterboxes [..., target,
    target, 3] (BGR, 0..255, gray 114 outside the content).

    selection=True takes the strided-selection lowering where the geometry
    allows it and returns uint8 whatever out_dtype is. Otherwise the
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
        out = torch.full((*lead, target, target, 3), C.LETTERBOX_PAD_RAW,
                         dtype=torch.uint8, device=frame_flat.device)
        out[..., pad_y:pad_y + new_h, pad_x:pad_x + new_w, :] = content
        return out
    Wy, Wx, mask = _interp_tensors(input_width, input_height, target,
                                   frame_flat.device)
    img = frame_flat.reshape(*lead, input_height, input_width * 3).float()
    a = (Wy @ img).reshape(*lead, target, input_width, 3)     # rows
    out = torch.einsum("...ywc,xw->...yxc", a, Wx)            # cols
    out = torch.where(mask[..., None], out, float(C.LETTERBOX_PAD_RAW))
    return out.to(out_dtype)


def unletterbox_coords(xy: np.ndarray, input_width: int, input_height: int,
                       target: int = C.DEFAULT_INPUT_SIZE) -> np.ndarray:
    """Map [..., 2] model-space coordinates back to frame pixels
    (reference: scaleTrackOutputs, src/main.cpp:48-68)."""
    scale, _, _, pad_x, pad_y = letterbox_params(input_width, input_height,
                                                 target)
    pad = np.asarray([pad_x, pad_y], np.float32)
    return (np.asarray(xy, np.float32) - pad) / np.float32(scale)

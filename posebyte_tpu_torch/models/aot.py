"""The locked engine: the forward with its weights baked in, exported
ahead of time, after posebyte_tpu/models/aot.py (reference:
saveEngine/loadEngine, yolo_pose_engine.cpp:413-495).

The JAX package exports StableHLO with jax.export; the port exports the
same program with torch.export into one .pt2 file: the graph of
forward_raw and the prepared weights (prepare_params' tensors, on the
device it was exported for). The program maps [B, S, S, 3] float32 NHWC ->
[B, 56, A] float32, the reference engine's output tensor. A w8a8 conv is
recorded as the operator posebyte::conv_w8a8 (ops.conv_int8.conv_w8a8_op),
registered when the port is imported, so the loaded program launches
Kernel 4 on the card as the eager forward does. For weights that can be
edited, use models/weights.py (safetensors).
"""
from __future__ import annotations

import os

import torch

from ..core.device import resolve_device, set_numeric_settings
from . import layers as L
from .layers import prepare_params
from .yolo_pose import MODEL_CONFIGS, anchor_tensors, forward_raw


class _LockedEngine(torch.nn.Module):
    """forward_raw over fixed weights, held as buffers (so that the export
    stores them) and handed to the forward under their checkpoint keys.
    A channels_last weight is stored as its contiguous NHWC permutation
    (the archive writes contiguous tensors whole) and viewed back in the
    forward, with no copy."""

    def __init__(self, prepared: dict, family: str, dtype: torch.dtype):
        super().__init__()
        self.keys = sorted(prepared)
        self.nhwc = set()
        for i, k in enumerate(self.keys):
            t = prepared[k]
            if t.dim() == 4 and not t.is_contiguous():
                t = t.permute(0, 2, 3, 1)
                self.nhwc.add(k)
            self.register_buffer(f"p{i}", t.contiguous())
        self.family = family
        self.dtype = dtype

    def forward(self, x):
        params = {}
        for i, k in enumerate(self.keys):
            t = getattr(self, f"p{i}")
            params[k] = t.permute(0, 3, 1, 2) if k in self.nhwc else t
        return forward_raw(params, x.to(self.dtype), self.family)


def export_engine_aot(params: dict, model_name: str, path: str,
                      batch: int = 1, input_size: int = 640,
                      dtype=torch.bfloat16, device=None) -> int:
    """Export the forward of `params` (the checkpoint's flat dict; int8
    w8a8 params run Kernel 4) at [batch, input_size, input_size, 3]
    float32 NHWC -> [batch, 56, A], computing in `dtype`, with the weights
    baked in, to `path`. device: where the program will run (None: the
    CUDA card, raising when there is none). Returns the file's size in
    bytes."""
    dev = resolve_device(device)
    set_numeric_settings()
    module = _LockedEngine(prepare_params(params, dtype, dev),
                           MODEL_CONFIGS[model_name].family, dtype)
    x = torch.zeros((batch, input_size, input_size, 3), dtype=torch.float32,
                    device=dev)
    # made here, outside the trace, so that the trace records the cached
    # tensors as constants and never caches one of its own fake tensors
    anchor_tensors(input_size, x.device)
    L._EXPORTING = True
    try:
        with torch.no_grad():
            program = torch.export.export(module, (x,))
    finally:
        L._EXPORTING = False
    torch.export.save(program, path)
    return os.path.getsize(path)


def load_engine_aot(path: str, device=None):
    """Load an exported engine; returns a callable images_nhwc float32
    [B, S, S, 3] -> raw [B, 56, A] on `device` (None: the CUDA card,
    raising when there is none). Raises when the file was exported for
    another kind of device."""
    dev = resolve_device(device)
    set_numeric_settings()
    program = torch.export.load(path)
    kinds = {t.device.type for t in program.state_dict.values()}
    if kinds != {dev.type}:
        raise ValueError(f"{path} holds a program for {sorted(kinds)}, not "
                         f"{dev.type}")
    module = program.module()

    def run(images_nhwc: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return module(images_nhwc)

    return run

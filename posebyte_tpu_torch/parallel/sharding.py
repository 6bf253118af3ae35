"""Multi-stream serving over several devices, after
posebyte_tpu/parallel/sharding.py (make_mesh, MultiStreamPipeline,
MultiStreamChunkPipeline).

Streams never communicate: each stream's tracker recurrence is its own.
So a mesh is an ordered list of devices in one process, and each device
runs a contiguous share of the S streams through the step the servers run
(pipeline.serving.StreamShards): its share's frames in one copy, the
detector on them as one batch, the tracker for the share, the packed
outputs back in one copy. Per frame step that is Kernel 1 at B = S / n
and Kernel 3 at K = 1 on each card; per chunk step Kernels 1 and 3 once
each on each card. The weights go to each device once; the tracker state
of a share never leaves its device. Every device's work is queued before
any output is read, so the cards run side by side.

A mesh may name one device more than once: that is how the CPU tests
build meshes of 2 and 4 on one CPU, as the JAX tests build them of
virtual devices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..pipeline.serving import StreamShards

# The activation type the JAX pipelines default to.
_DEFAULT_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered list of devices along one named axis."""
    devices: tuple
    axis_name: str = "stream"

    @property
    def shape(self) -> dict:
        return {self.axis_name: len(self.devices)}


def make_mesh(n_devices: int | None = None, axis_name: str = "stream",
              device=None) -> Mesh:
    """A 1-D mesh of n_devices: the CUDA cards 0..n-1 (default all of
    them; raises without a card), or with device given (e.g. "cpu") that
    device n times (default once)."""
    if device is not None:
        return Mesh(tuple([torch.device(device)] * (n_devices or 1)),
                    axis_name)
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for a mesh on the CPU")
    n = n_devices or count
    if n > count:
        raise ValueError(f"{n} devices asked for, {count} present")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis_name)


class MultiStreamPipeline:
    """Batched multi-stream tracking: frames [S, H, W, 3] u8, every stream
    advancing one frame a call, each mesh device running its share
    (module docstring). params None draws random weights from seed
    (models.init_params); dtype overrides config.precision's activation
    type (the JAX class's default, bf16, when neither says otherwise);
    reid_params the learned Re-ID head. mesh None is make_mesh(): every
    card."""

    _selection = False        # the per-frame letterbox, as the JAX class

    def __init__(self, num_streams: int,
                 config: PipelineConfig = PipelineConfig(),
                 mesh: Mesh | None = None, params=None, seed: int = 0,
                 dtype=_DEFAULT_DTYPE, reid_params=None):
        self.config = config
        self.num_streams = num_streams
        self.mesh = mesh if mesh is not None else make_mesh()
        self.shards = StreamShards(num_streams, config, params, dtype=dtype,
                                   reid_params=reid_params, seed=seed,
                                   mesh=self.mesh)

    @property
    def states(self):
        """The streams' TrackerState with a leading S axis (on the CPU
        when the mesh has several devices)."""
        return self.shards.states

    def _run(self, frames: np.ndarray, k: int) -> dict:
        s, h, w = frames.shape[0], frames.shape[-3], frames.shape[-2]
        flat = torch.from_numpy(np.ascontiguousarray(frames, np.uint8)
                                .reshape(s, k, -1))
        return self.shards.run(flat, None, None, h, w, self._selection)

    def process_frames(self, frames: np.ndarray) -> dict:
        """frames [S, H, W, 3] u8 -> host outputs with a leading [S] axis:
        ids, scores, poses, boxes, emit, num_active."""
        if frames.shape[0] != self.num_streams:
            raise ValueError(f"{frames.shape[0]} frames for "
                             f"{self.num_streams} streams")
        return {k: v[:, 0] for k, v in self._run(frames, 1).items()}


class MultiStreamChunkPipeline(MultiStreamPipeline):
    """Chunked multi-stream processing: frames [S, K, H, W, 3] a call, the
    detector batched over each share's streams x frames (the strided
    selection letterbox, as the chunk paths) and each stream's K-frame
    recurrence in its device's one Kernel 3 launch."""

    _selection = True

    def __init__(self, num_streams: int, chunk: int,
                 config: PipelineConfig = PipelineConfig(),
                 mesh: Mesh | None = None, params=None, seed: int = 0,
                 dtype=_DEFAULT_DTYPE, reid_params=None):
        super().__init__(num_streams, config, mesh, params, seed, dtype,
                         reid_params)
        self.chunk = chunk

    def process_chunks(self, frames: np.ndarray) -> dict:
        """frames [S, K, H, W, 3] u8 -> host outputs with leading [S, K]
        axes."""
        if frames.shape[:2] != (self.num_streams, self.chunk):
            raise ValueError(f"frames {frames.shape[:2]}: expected "
                             f"({self.num_streams}, {self.chunk})")
        return self._run(frames, self.chunk)

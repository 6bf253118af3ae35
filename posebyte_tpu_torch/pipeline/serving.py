"""Multi-stream serving: a fixed pool of S stream slots with open, close,
reuse and starvation, after posebyte_tpu/pipeline/serving.py.

One step serves every slot at once, whatever its stream is doing; stream
dynamics are host-side masks fed into the step:
  * reset [S]: the flagged slots' tracker state (every field, the filter
    and the embeddings included) is re-initialised by torch.where before
    the step, whatever advance says (stream open, slot reuse); a step
    that resets no slot skips it;
  * advance: a slot whose stream has no queued frame keeps its state
    unchanged (a starved stream does not age its tracks) and emits
    nothing.

A step makes one host-to-device copy of the frames of all S slots (zeros
where a slot has none), runs the detector front end (pipeline.runner.
Detector, the one PosePipeline runs) on them as one batch, so that
pose-NMS is one Kernel 1 launch, and runs the tracker for all slots as
one Kernel 3 launch (ops.tracker_chunk, grid = S), with the state's
leading S axis. No loop over streams launches anything. The outputs go to
the host in one copy (runner.pack_outputs) and are appended per stream as
host dicts per frame with the keys ids, scores, poses, boxes, emit and
num_active.
  * StreamServer takes at most one frame per stream a step: the
    detector on [S, H*W*3] with the matmul letterbox (selection=False),
    Kernel 1 at B = S, Kernel 3 at K = 1 with advance [S, 1]. The JAX
    per-frame server vmaps tracker_step over streams; the port's
    tracker_step is unbatched, so a loop of it would make 3 S Kernel 2
    launches a step. Kernel 3 computes the same frame update bit for bit
    (it is held against tracker_chunk_plain, a loop of tracker_step) in
    one launch for all streams.
  * ChunkedStreamServer takes up to `chunk` frames per stream a step: the
    detector on [S * K, H*W*3] with the selection letterbox, Kernel 1 at
    B = S K, Kernel 3 with advance [S, K], as the TPU branch of the JAX
    chunk server runs its fused kernel.
On the CPU both servers run tracker_chunk_plain. A frame that does not
advance reports ids -1 from Kernel 3 and its plain version, where the JAX
CPU scan reports the unchanged state's; only advanced frames are ever
appended to a stream's outputs, so no caller sees the difference.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..core.structs import TrackerState
from ..ops.tracker_chunk import _stack, tracker_chunk
from .runner import Detector, pack_outputs, unpack_outputs


def _select(mask: torch.Tensor, a, b):
    """Field-wise torch.where(mask[s], a, b) of two TrackerStates with a
    leading stream axis S; mask [S] bool."""
    def pick(x, y):
        return torch.where(mask.view(-1, *([1] * (x.dim() - 1))), x, y)
    return dataclasses.replace(b, **{
        f.name: pick(getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(b)})


class StreamServer:
    """Dynamic multi-video serving over a fixed slot pool.

    Usage:
        srv = StreamServer(8, (1080, 1920), config, params)
        sid = srv.open_stream()
        srv.submit(sid, frame)          # enqueue; any number of streams
        n = srv.step()                  # one step for every slot
        for out in srv.poll(sid): ...   # drained per-stream outputs
        srv.close_stream(sid)           # EOS; the slot returns to the pool

    params, device, dtype, heads_fn and reid_params are those of the
    Detector (pipeline.runner): the checkpoint is required, device None is
    the CUDA card and raises without one, "cpu" runs the plain versions.
    Reopening a slot resets its tracker state on the next step. `states`
    is the pool's TrackerState with a leading S axis."""

    _selection = False      # the per-frame letterbox lowering

    def __init__(self, num_streams: int, frame_shape: tuple[int, int],
                 config: PipelineConfig = PipelineConfig(),
                 params: dict | None = None, device=None, dtype=None,
                 heads_fn=None, reid_params: dict | None = None):
        self._setup(num_streams, frame_shape, 1, config, params, device,
                    dtype, heads_fn, reid_params)

    def _setup(self, num_streams, frame_shape, chunk, config, params, device,
               dtype, heads_fn, reid_params):
        if num_streams < 1 or chunk < 1:
            raise ValueError(f"num_streams {num_streams} and chunk {chunk} "
                             "must be positive")
        self.detector = Detector(config, params, device, dtype, heads_fn,
                                 reid_params)
        self.config = self.detector.config
        self.device = self.detector.device
        trk_cfg = self.config.tracker
        if self.device.type == "cuda" and not trk_cfg.torso_tier:
            raise NotImplementedError("Kernel 3 always runs the torso tier "
                                      "(torso_tier=True)")
        self.num_streams = num_streams
        self.frame_h, self.frame_w = frame_shape
        self._fresh = _stack([TrackerState.init(
            trk_cfg.max_tracks, trk_cfg.max_detections, self.device)]
            * num_streams)
        self.states = self._fresh
        # The step's frames, reused: pinned on the card, so that the copy
        # is one DMA. A step ends by copying its outputs to the host, after
        # which its frames' copy has finished.
        self._frames_t = torch.zeros(
            (num_streams, chunk, self.frame_h * self.frame_w * 3),
            dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        self._frames = self._frames_t.numpy()
        self._filled = np.zeros((num_streams, chunk), bool)
        self._open = [False] * num_streams
        self._pending_reset = np.zeros(num_streams, bool)
        self._in: list = [collections.deque() for _ in range(num_streams)]
        self._out: list = [collections.deque() for _ in range(num_streams)]

    # -- lifecycle ---------------------------------------------------------
    def open_stream(self) -> int:
        """Claim a free slot; its tracker state resets on the next step.
        Raises RuntimeError when the pool is exhausted."""
        for sid in range(self.num_streams):
            if not self._open[sid]:
                self._open[sid] = True
                self._pending_reset[sid] = True
                self._in[sid].clear()
                self._out[sid].clear()
                return sid
        raise RuntimeError(
            f"all {self.num_streams} stream slots in use")

    def close_stream(self, sid: int):
        """EOS: release the slot. Pending inputs are dropped; outputs
        already produced stay pollable until the slot is reopened."""
        self._check(sid)
        self._open[sid] = False
        self._in[sid].clear()

    # -- data plane ---------------------------------------------------------
    def submit(self, sid: int, frame_bgr: np.ndarray):
        self._check(sid)
        if frame_bgr.shape != (self.frame_h, self.frame_w, 3):
            raise ValueError(
                f"frame {frame_bgr.shape} != server geometry "
                f"{(self.frame_h, self.frame_w, 3)}")
        self._in[sid].append(np.ascontiguousarray(frame_bgr))

    def step(self) -> int:
        """One step: consumes up to K queued frames per open stream (K = 1
        here, `chunk` for ChunkedStreamServer). Returns the number of
        frames consumed (0 = nothing queued; nothing runs)."""
        S, K = self._frames.shape[:2]
        advance = np.zeros((S, K), bool)
        for sid in range(S):
            if not self._open[sid]:
                continue
            for k in range(K):
                if not self._in[sid]:
                    break
                self._frames[sid, k] = self._in[sid].popleft().reshape(-1)
                advance[sid, k] = True
        served = int(advance.sum())
        if served == 0:
            return 0
        self._frames[self._filled & ~advance] = 0   # slots without a frame
        self._filled = advance
        reset = self._pending_reset.copy()
        self._pending_reset[:] = False
        host = self._dispatch(advance, reset)
        for sid, k in zip(*np.nonzero(advance)):
            self._out[sid].append({key: v[sid, k]
                                   for key, v in host.items()})
        return served

    def _dispatch(self, advance: np.ndarray, reset: np.ndarray) -> dict:
        """Every slot's frames through the detector and the tracker: one
        copy of the frames in, one of the packed outputs out. Returns the
        host outputs with leading axes [S, K]."""
        S, K = advance.shape
        det = self.detector
        trk_cfg = self.config.tracker
        dev = self.device
        masks = torch.from_numpy(
            np.concatenate([advance, reset[:, None]], axis=1)).to(dev)
        with torch.inference_mode():
            frames = self._frames_t.to(dev, non_blocking=True)
            adv, rst = masks[:, :K], masks[:, K]
            state = (_select(rst, self._fresh, self.states) if reset.any()
                     else self.states)
            dets, emb = det(frames.flatten(0, 1), self.frame_h, self.frame_w,
                            selection=self._selection)
            dets = dataclasses.replace(dets, **{
                f.name: getattr(dets, f.name).unflatten(0, (S, K))
                for f in dataclasses.fields(dets)})
            if emb is not None:
                emb = emb.unflatten(0, (S, K))
            self.states, outs = tracker_chunk(state, dets, trk_cfg, adv,
                                              emb)
            return unpack_outputs(pack_outputs(outs).cpu().numpy())

    def poll(self, sid: int):
        """Drain and return this stream's completed outputs. Allowed on
        closed streams too (EOS leaves produced outputs pollable until the
        slot is reopened)."""
        if not (0 <= sid < self.num_streams):
            raise KeyError(f"stream {sid} out of range")
        outs = list(self._out[sid])
        self._out[sid].clear()
        return outs

    def _check(self, sid: int):
        if not (0 <= sid < self.num_streams) or not self._open[sid]:
            raise KeyError(f"stream {sid} is not open")


class ChunkedStreamServer(StreamServer):
    """StreamServer that takes up to `chunk` queued frames per stream a
    step: the detector batched over streams x frames, the tracker as one
    Kernel 3 launch with a per-frame advance mask, so a stream with fewer
    than `chunk` queued frames advances by what it has. The same
    open/close/submit/poll lifecycle."""

    _selection = True       # the chunk paths' letterbox lowering

    def __init__(self, num_streams: int, frame_shape: tuple[int, int],
                 chunk: int = 8, config: PipelineConfig = PipelineConfig(),
                 params: dict | None = None, device=None, dtype=None,
                 heads_fn=None, reid_params: dict | None = None):
        self._setup(num_streams, frame_shape, chunk, config, params, device,
                    dtype, heads_fn, reid_params)
        self.chunk = chunk

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
With mesh= (parallel.make_mesh) the slots are spread over the mesh's
devices in contiguous shares (StreamShards), each device running the step
above for its share: Kernel 1 at B = S / n and Kernel 3 over its S / n
streams, one copy in and one out per device.
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
from ..core.device import resolve_device
from .runner import Detector, model_params, pack_outputs, unpack_outputs


def _select(mask: torch.Tensor, a, b):
    """Field-wise torch.where(mask[s], a, b) of two TrackerStates with a
    leading stream axis S; mask [S] bool."""
    def pick(x, y):
        return torch.where(mask.view(-1, *([1] * (x.dim() - 1))), x, y)
    return dataclasses.replace(b, **{
        f.name: pick(getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(b)})


class StreamShards:
    """S stream slots spread over the devices of a mesh (or one device),
    each device holding a contiguous share of S / n slots, its share's
    tracker state and a Detector with the weights (one per distinct
    device): the step both servers and parallel.MultiStream*Pipeline run.

    run() sends each share's frames to its device, runs the detector on
    them as one batch (one Kernel 1 launch on a card) and the tracker for
    the share (one Kernel 3 launch), every device's work queued before
    any output is copied back, so that the devices run side by side.
    mesh: an object with a `devices` sequence (parallel.make_mesh; a
    device may appear more than once, as the CPU tests build meshes);
    None runs every slot on `device`."""

    def __init__(self, num_streams: int, config: PipelineConfig, params,
                 device=None, dtype=None, heads_fn=None, reid_params=None,
                 seed: int = 0, mesh=None):
        devices = [device] if mesh is None else list(mesh.devices)
        if num_streams % len(devices):
            raise ValueError(f"{num_streams} streams do not divide over "
                             f"{len(devices)} mesh devices")
        params = model_params(config, params, heads_fn, seed)
        per = num_streams // len(devices)
        detectors: dict = {}
        self.shards = []
        for i, dev in enumerate(devices):
            dev = resolve_device(dev)
            if dev not in detectors:
                detectors[dev] = Detector(config, params, dev, dtype,
                                          heads_fn, reid_params)
            det = detectors[dev]
            trk_cfg = det.config.tracker
            if dev.type == "cuda" and not trk_cfg.torso_tier:
                raise NotImplementedError("Kernel 3 always runs the torso "
                                          "tier (torso_tier=True)")
            fresh = _stack([TrackerState.init(
                trk_cfg.max_tracks, trk_cfg.max_detections, dev)] * per)
            self.shards.append({"detector": det, "slots": slice(i * per,
                                                                (i + 1) * per),
                                "fresh": fresh, "state": fresh})
        self.detector = self.shards[0]["detector"]
        self.pinned = any(d.type == "cuda" for d in detectors)

    @property
    def states(self) -> TrackerState:
        if len(self.shards) == 1:
            return self.shards[0]["state"]
        states = [sh["state"] for sh in self.shards]
        return dataclasses.replace(states[0], **{
            f.name: torch.cat([getattr(st, f.name).cpu() for st in states])
            for f in dataclasses.fields(states[0])})

    def run(self, frames_t: torch.Tensor, advance: np.ndarray | None,
            reset: np.ndarray | None, h: int, w: int,
            selection: bool) -> dict:
        """frames_t [S, K, H*W*3] u8 on the host; advance [S, K] bool (None:
        every frame advances); reset [S] bool (None: no slot resets).
        Returns the host outputs (ids, scores, poses, boxes, emit,
        num_active) with leading axes [S, K]."""
        with torch.inference_mode():
            # Every share's masks first, one copy each: a copy from
            # pageable memory waits for what its stream has queued, so it
            # goes ahead of the frames' copies.
            masks = [self._masks(sh, advance, reset) for sh in self.shards]
            packed = [self._run_shard(sh, m, frames_t, h, w, selection)
                      for sh, m in zip(self.shards, masks)]
            host = [unpack_outputs(p.cpu().numpy()) for p in packed]
        if len(host) == 1:
            return host[0]
        return {k: np.concatenate([o[k] for o in host]) for k in host[0]}

    @staticmethod
    def _masks(sh, advance, reset):
        """(advance [S/n, K] or None, reset [S/n] or None) on the share's
        device, from one copy of both."""
        sl = sh["slots"]
        if advance is None and reset is None:
            return None, None
        n = sl.stop - sl.start
        adv = np.ones((n, 0), bool) if advance is None else advance[sl]
        rst = np.zeros(n, bool) if reset is None else reset[sl]
        m = torch.from_numpy(np.concatenate([adv, rst[:, None]], axis=1)
                             ).to(sh["detector"].device)
        return (None if advance is None else m[:, :-1],
                m[:, -1] if rst.any() else None)

    @staticmethod
    def _run_shard(sh, masks, frames_t, h, w, selection):
        det, sl = sh["detector"], sh["slots"]
        frames = frames_t[sl].to(det.device, non_blocking=True)
        S, K = frames.shape[:2]
        adv, rst = masks
        state = sh["state"]
        if rst is not None:
            state = _select(rst, sh["fresh"], state)
        dets, emb = det(frames.flatten(0, 1), h, w, selection=selection)
        dets = dataclasses.replace(dets, **{
            f.name: getattr(dets, f.name).unflatten(0, (S, K))
            for f in dataclasses.fields(dets)})
        if emb is not None:
            emb = emb.unflatten(0, (S, K))
        sh["state"], outs = tracker_chunk(state, dets, det.config.tracker,
                                          adv, emb)
        return pack_outputs(outs)


class StreamServer:
    """Dynamic multi-video serving over a fixed slot pool.

    Usage:
        srv = StreamServer(8, (1080, 1920), config, params)
        sid = srv.open_stream()
        srv.submit(sid, frame)          # enqueue; any number of streams
        n = srv.step()                  # one step for every slot
        for out in srv.poll(sid): ...   # drained per-stream outputs
        srv.close_stream(sid)           # EOS; the slot returns to the pool

    params, device, dtype, heads_fn, reid_params and seed are those of the
    Detector (pipeline.runner): params None draws random weights from
    seed, device None is the CUDA card and raises without one, "cpu" runs
    the plain versions. mesh (parallel.make_mesh) spreads the slots over
    its devices in contiguous shares, each device running its share's step
    (StreamShards); it replaces `device`. Reopening a slot resets its
    tracker state on the next step. `states` is the pool's TrackerState
    with a leading S axis."""

    _selection = False      # the per-frame letterbox lowering

    def __init__(self, num_streams: int, frame_shape: tuple[int, int],
                 config: PipelineConfig = PipelineConfig(),
                 params: dict | None = None, device=None, dtype=None,
                 heads_fn=None, reid_params: dict | None = None,
                 seed: int = 0, mesh=None):
        self._setup(num_streams, frame_shape, 1, config, params, device,
                    dtype, heads_fn, reid_params, seed, mesh)

    def _setup(self, num_streams, frame_shape, chunk, config, params, device,
               dtype, heads_fn, reid_params, seed, mesh):
        if num_streams < 1 or chunk < 1:
            raise ValueError(f"num_streams {num_streams} and chunk {chunk} "
                             "must be positive")
        self.shards = StreamShards(num_streams, config, params, device,
                                   dtype, heads_fn, reid_params, seed, mesh)
        self.detector = self.shards.detector
        self.config = self.detector.config
        self.device = self.detector.device
        self.num_streams = num_streams
        self.frame_h, self.frame_w = frame_shape
        # The step's frames, reused: pinned where a card takes them, so
        # that the copy is one DMA. A step ends by copying its outputs to
        # the host, after which its frames' copy has finished.
        self._frames_t = torch.zeros(
            (num_streams, chunk, self.frame_h * self.frame_w * 3),
            dtype=torch.uint8, pin_memory=self.shards.pinned)
        self._frames = self._frames_t.numpy()
        self._filled = np.zeros((num_streams, chunk), bool)
        self._open = [False] * num_streams
        self._pending_reset = np.zeros(num_streams, bool)
        self._in: list = [collections.deque() for _ in range(num_streams)]
        self._out: list = [collections.deque() for _ in range(num_streams)]

    @property
    def states(self) -> TrackerState:
        """The pool's TrackerState with a leading S axis (gathered on the
        CPU when a mesh holds it on several devices)."""
        return self.shards.states

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
        copy of the frames in and one of the packed outputs out per mesh
        device. Returns the host outputs with leading axes [S, K]."""
        return self.shards.run(self._frames_t, advance, reset, self.frame_h,
                               self.frame_w, self._selection)

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
                 heads_fn=None, reid_params: dict | None = None,
                 seed: int = 0, mesh=None):
        self._setup(num_streams, frame_shape, chunk, config, params, device,
                    dtype, heads_fn, reid_params, seed, mesh)
        self.chunk = chunk

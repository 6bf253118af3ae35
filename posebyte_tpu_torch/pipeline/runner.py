"""The pose pipeline: letterbox -> YOLO-pose -> decode -> pose-NMS ->
tracker -> outputs, after posebyte_tpu/pipeline/runner.py.

Two paths, as in the JAX package:
- per frame (runner.py:149-194, :340-415): process_frame, or
  prestage_frame + process_frame_device, or the depth-pipelined
  process_stream; the tracker is tracker_step, whose three auctions are
  Kernel 2 on the card.
- per chunk of K frames (runner.py:197-338): chunk_body, process_chunk,
  stage_chunk + process_chunk_device. Letterbox (strided selection),
  model, decode and NMS run batched over the K frames (Kernel 1 once, grid
  = K), and the tracker recurrence runs as one Kernel 3 launch.
Both paths run either motion model (config.tracker.motion_model: "cv", or
"kalman136", whose filter travels in the state's kf_mean and kf_cov).
With config.tracker.reid_weight > 0 both paths compute an appearance
embedding per detection from the letterboxed image (ops/reid.py: the
pose-colour descriptor, or the learned head of models/reid_head.py when
reid_params are given) and hand it to the tracker.
Both paths, and both stream servers (pipeline/serving.py), run one
detector front end, Detector: the model on the raw letterbox (stem folded)
or, with raw_preproc=False, on the normalised one, or an injected heads_fn
such as the oracle of models/oracle.py. With
config.detector.decode_fusion="tail" the model's candidates are chosen per
pyramid level (forward_head_maps, decode_topk_levels; runner.py:39-70,
:111-114 of the JAX package), with Detections equal to "post"'s bit for
bit; an injected heads_fn has no per-level maps and runs "post".
detect_fn and detect_fn_levels are the single-image detect of either
decode.
Everything from the frames' bytes to the per-detection track outputs runs
on the pipeline's device; the host copies frames in and, in fetch_outputs
or fetch_chunk_outputs, the small output tensors out. PyTorch runs
eagerly, so a step is a plain method.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..core.config import PipelineConfig
from ..core.device import resolve_device, set_numeric_settings
from ..core.structs import Detections, TrackerState
from ..models.layers import prepare_params
from ..models.weights import fold_stem_preprocess
from ..models.yolo_pose import (MODEL_CONFIGS, forward_head_maps,
                                forward_heads, init_params, make_anchors)
from ..ops.decode import decode_topk, decode_topk_levels
from ..ops.nms import MAX_N as NMS_MAX_N, pose_nms
from ..ops.preprocess import letterbox_flat_nhwc, letterbox_params
from ..ops.reid import make_embed_fn
from ..ops.tracker_chunk import tracker_chunk
from ..tracker.output import (TrackOutput, extract_outputs_device,
                             pack_outputs, unpack_outputs)
from ..tracker.step import tracker_step
from ..utils.profiling import STAGES

# The activations' type per precision; int8 runs bf16 activations between
# its w8a8 convolutions, as the JAX runner does.
_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
           "int8": torch.bfloat16}


def _span(name: str) -> record_function:
    """The profiler range `name`, which utils/profiling.py's STAGES, the one
    table of the port's range names, must hold: its readers skip those
    names when they sum kernels. A range costs a few microseconds of host
    time when no profiler is active."""
    if name not in STAGES:
        raise ValueError(f"profiler range {name!r} is not in STAGES")
    return record_function(name)


def chunk_tracks(ids, scores, poses, boxes, emit, frame_w: int,
                 frame_h: int, input_size: int) -> list:
    """A chunk's host outputs, leading axes [K, D] (unpack_outputs') -> K
    lists of TrackOutput in frame coordinates, each in slot order
    (reference: getActiveTracks + scaleTrackOutputs, main.cpp:48-68, 224).
    One pass over the chunk's emitted rows: the gathers copy them out of
    the host arrays, and one expression un-letterboxes them all, the same
    float32 arithmetic per value as one frame at a time."""
    scale, _, _, pad_x, pad_y = letterbox_params(frame_w, frame_h,
                                                 input_size)
    pad = np.asarray([pad_x, pad_y], np.float32)
    f, d = np.nonzero(emit)
    kps, bbs = poses[f, d], boxes[f, d]
    kps[..., :2] = (kps[..., :2] - pad) / scale
    corners = bbs.reshape(-1, 2, 2)
    corners[...] = (corners - pad) / scale
    results = [[] for _ in range(len(emit))]
    for fi, i, s, bb, kp in zip(f.tolist(), ids[f, d].tolist(),
                                scores[f, d].tolist(), bbs, kps):
        results[fi].append(TrackOutput(track_id=i, score=s, bbox=bb,
                                       keypoints=kp))
    return results


def frame_tracks(ids, scores, poses, boxes, emit, frame_w: int,
                 frame_h: int, input_size: int) -> list:
    """One frame's host outputs, leading axis [D] -> list of TrackOutput:
    chunk_tracks at K = 1."""
    return chunk_tracks(ids[None], scores[None], poses[None], boxes[None],
                        emit[None], frame_w, frame_h, input_size)[0]


def _decode(det_cfg, box, cls, kpt) -> Detections:
    return decode_topk(box, cls, kpt, det_cfg.conf_threshold,
                       det_cfg.max_candidates, det_cfg.input_size,
                       topk_impl=det_cfg.topk_impl,
                       gather_impl=det_cfg.gather_impl)


def _decode_levels(det_cfg, levels) -> Detections:
    return decode_topk_levels(levels, det_cfg.conf_threshold,
                              det_cfg.max_candidates, det_cfg.input_size,
                              topk_impl=det_cfg.topk_impl,
                              gather_impl=det_cfg.gather_impl)


def _nms(det_cfg, det: Detections) -> Detections:
    return pose_nms(det, det_cfg.iou_threshold, det_cfg.oks_threshold,
                    det_cfg.max_detections, presorted=True)


def detect_fn(params, image_hwc: torch.Tensor, det_cfg, heads_fn
              ) -> Detections:
    """Single-image detect: [S, S, 3] input -> pose-NMS'd Detections
    (reference: detectGPUNative, yolo_pose_engine.cpp:610-646): heads_fn
    (params, images_nhwc) -> (box, cls, kpt) on a batch of one, the sparse
    decode, pose_nms (Kernel 1 on the card)."""
    box, cls, kpt = heads_fn(params, image_hwc[None])
    return _nms(det_cfg, _decode(det_cfg, box[0], cls[0], kpt[0]))


def detect_fn_levels(params, image_hwc: torch.Tensor, det_cfg,
                     head_maps_fn) -> Detections:
    """Single-image detect through the tail-fused decode: head_maps_fn
    (params, images_nhwc) -> per-level maps (models.build_model_head_maps),
    decode_topk_levels, pose_nms. The Detections equal detect_fn's bit for
    bit."""
    maps = head_maps_fn(params, image_hwc[None])
    levels = tuple((b[0], c[0], k[0]) for b, c, k in maps)
    return _nms(det_cfg, _decode_levels(det_cfg, levels))


def model_params(config: PipelineConfig, params: dict | None, heads_fn,
                 seed: int = 0) -> dict:
    """`params`, or with params None the model's random weights from
    `seed` (init_params); an injected detector needs its own."""
    if params is not None:
        return params
    if heads_fn is not None:
        raise ValueError("an injected heads_fn needs its params")
    return init_params(seed, config.model_name)


class Detector:
    """The detector front end, one for PosePipeline and both stream
    servers (pipeline/serving.py), so that they cannot drift apart: flat
    u8 frames [B, H*W*3] -> letterbox -> heads -> decode -> pose-NMS
    (Kernel 1 once for the batch) -> (compacted, score-descending
    Detections [B, max_detections], their appearance embeddings [B,
    max_detections, 51] or None without Re-ID).

    params: the unfolded checkpoint in the port's layout
    (models.load_params / models.params_from_jax), or the injected
    detector's; None draws the model's random weights from `seed`
    (models.init_params), as the JAX package does. heads_fn: optional
    (params, images_nhwc) -> (box [B, A, 64], cls [B, A, 1], kpt [B, A,
    51]) in place of the model, e.g.
    models.oracle.make_oracle_heads(); it forces raw_preproc=False (there
    is no stem to fold the normalisation into) and its params go to the
    device as they are. With the model, raw_preproc=True folds the BGR flip
    and /255 into the stem conv and feeds it the raw letterbox; False feeds
    the unfolded model the normalised letterbox. device: None is the CUDA
    card (raising when there is none), "cpu" runs the plain versions of the
    kernels. dtype overrides the activations' type of config.precision.
    Constructing it sets the process-wide numeric settings
    (core.set_numeric_settings: TF32 off, cuDNN autotuning off)."""

    def __init__(self, config: PipelineConfig, params: dict | None,
                 device=None, dtype=None, heads_fn=None,
                 reid_params: dict | None = None, seed: int = 0):
        params = model_params(config, params, heads_fn, seed)
        if config.precision not in _DTYPES:
            raise NotImplementedError(
                f"precision {config.precision!r} is not ported")
        if heads_fn is not None and config.detector.raw_preproc:
            config = dataclasses.replace(config, detector=dataclasses.replace(
                config.detector, raw_preproc=False))
        det_cfg = config.detector
        self.config = config
        self.device = resolve_device(device)
        n_cand = min(det_cfg.max_candidates,
                     len(make_anchors(det_cfg.input_size)[0]))
        if self.device.type == "cuda" and n_cand > NMS_MAX_N:
            raise ValueError(f"{n_cand} NMS candidates per frame: Kernel 1 "
                             f"takes at most {NMS_MAX_N}")
        set_numeric_settings()
        self.dtype = _DTYPES[config.precision] if dtype is None else dtype
        if heads_fn is None:
            self.family = MODEL_CONFIGS[config.model_name].family
            if det_cfg.raw_preproc:
                params = fold_stem_preprocess(params)
            self.params = prepare_params(params, self.dtype, self.device)
            self.heads = self._model_heads
            self.head_maps = self._model_head_maps \
                if det_cfg.decode_fusion == "tail" else None
        else:
            self.family = None
            self.params = {k: torch.as_tensor(v).to(self.device)
                           for k, v in params.items()}
            self.heads = heads_fn
            self.head_maps = None       # no per-level maps: "post"
        self.reid_params = None if reid_params is None else {
            k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
            for k, v in reid_params.items()}
        self.embed = None
        if config.tracker.reid_weight > 0.0:
            self.embed = make_embed_fn(self.reid_params,
                                       raw_input=det_cfg.raw_preproc)

    def _model_heads(self, params, imgs: torch.Tensor):
        return forward_heads(params, imgs.to(self.dtype), self.family)

    def _model_head_maps(self, params, imgs: torch.Tensor):
        return forward_head_maps(params, imgs.to(self.dtype), self.family)

    def __call__(self, frames_flat: torch.Tensor, h: int, w: int,
                 selection: bool):
        """frames_flat [B, H*W*3] u8 on the device. selection takes the
        strided-selection letterbox (the chunk paths), else the matmul
        lowering (the per-frame paths). The stages carry profiler labels
        (utils/profiling.py reads them); a label costs a few microseconds
        of host time when no profiler is active."""
        det_cfg = self.config.detector
        # With Re-ID the letterbox stays float32: the interpolated
        # letterbox holds fractional values, which the appearance source
        # samples and a bf16 letterbox would round (the raw selection
        # lowering returns exact uint8 either way). The model casts to its
        # dtype.
        lb_dtype = self.dtype if self.embed is None else torch.float32
        with _span("letterbox"):
            imgs = letterbox_flat_nhwc(frames_flat, w, h,
                                       det_cfg.input_size,
                                       out_dtype=lb_dtype,
                                       selection=selection,
                                       raw=det_cfg.raw_preproc)
        with _span("model"):
            if self.head_maps is not None:
                heads = self.head_maps(self.params, imgs)
            else:
                heads = self.heads(self.params, imgs)
        with _span("decode"):
            if self.head_maps is not None:
                det = _decode_levels(det_cfg, heads)
            else:
                det = _decode(det_cfg, *heads)
        with _span("nms"):
            det = _nms(det_cfg, det)
        if self.embed is None:
            return det, None
        with _span("reid"):
            return det, self.embed(imgs, det.poses)


class PosePipeline:
    """End-to-end pose tracking on one device.

    config, params, device, dtype, heads_fn, reid_params and seed are
    those of the Detector it runs (see there; params None draws random
    weights from seed). reid_params: optional learned Re-ID
    head weights (models.load_reid_head); with config.tracker.reid_weight >
    0 the tracker's appearance embeddings come from that head, else from
    the pose-colour descriptor.

    The parameters decide each conv's flavour, as in the JAX package:
    precision="int8" with models.quant's calibrated parameters runs every
    quantised conv as w8a8 through Kernel 4 (weights packed here, once)."""

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 params: dict | None = None, device=None,
                 reid_params: dict | None = None, dtype=None,
                 heads_fn=None, seed: int = 0):
        self.detector = Detector(config, params, device, dtype, heads_fn,
                                 reid_params, seed)
        trk_cfg = self.config.tracker
        self.state = TrackerState.init(trk_cfg.max_tracks,
                                       trk_cfg.max_detections, self.device)
        # As the JAX runner keeps it: every entry point counts its frames,
        # only process_frame adds its host time to dispatch_ms.
        self.timing = {"dispatch_ms": 0.0, "frames": 0}

    # The Detector's fields, read through it.
    config = property(lambda self: self.detector.config)
    device = property(lambda self: self.detector.device)
    dtype = property(lambda self: self.detector.dtype)
    family = property(lambda self: self.detector.family)
    params = property(lambda self: self.detector.params)

    def _step(self, frame_flat: torch.Tensor, h: int, w: int):
        """One frame on the device: the detector on a batch of one, then
        tracker_step and the outputs."""
        trk_cfg = self.config.tracker
        det, emb = self.detector(frame_flat[None], h, w, selection=False)
        det = Detections(det.poses[0], det.boxes[0], det.scores[0],
                         det.valid[0])
        with _span("tracker"):
            state, aux = tracker_step(self.state, det, trk_cfg,
                                      None if emb is None else emb[0])
        with _span("outputs"):
            ids, scores, poses, boxes, emit = extract_outputs_device(
                state, det.scores, trk_cfg)
        out = {"ids": ids, "scores": scores, "poses": poses, "boxes": boxes,
               "emit": emit, "num_active": aux["num_active"],
               "det_scores": det.scores, "det_valid": det.valid}
        return state, out

    def chunk_body(self, k: int, h: int, w: int):
        """The chunk step as a function (state, frames_flat [k, H*W*3] u8
        on the device) -> (state, outs), outs with a leading k axis: ids,
        scores, poses, boxes, emit, num_active."""
        trk_cfg = self.config.tracker

        def body(state, frames_flat):
            if tuple(frames_flat.shape) != (k, h * w * 3):
                raise ValueError(f"chunk_body({k}, {h}, {w}) got frames "
                                 f"{tuple(frames_flat.shape)}")
            det, emb = self.detector(frames_flat, h, w, selection=True)
            with _span("tracker"):
                return tracker_chunk(state, det, trk_cfg,
                                     det_embeddings=emb)

        return body

    def _stage(self, frames_bgr: np.ndarray, shape) -> torch.Tensor:
        """Start the copy of u8 frames to the device, reshaped to `shape`:
        through a pinned host buffer (PyTorch's caching host allocator)
        with a non-blocking copy, so it overlaps work already queued (the
        counterpart of the JAX package's staged device buffers)."""
        flat = torch.from_numpy(np.ascontiguousarray(
            frames_bgr, dtype=np.uint8).reshape(shape))
        with _span("ingest"):
            if self.device.type != "cuda":
                return flat.to(self.device)
            return flat.pin_memory().to(self.device, non_blocking=True)

    def stage_chunk(self, frames_bgr: np.ndarray) -> torch.Tensor:
        """Start the copy of a chunk [K, H, W, 3] u8 to the device; returns
        the device tensor [K, H*W*3] for process_chunk_device."""
        return self._stage(frames_bgr, (frames_bgr.shape[0], -1))

    def process_chunk_device(self, frames_flat: torch.Tensor, h: int,
                             w: int):
        """Run a staged chunk [K, H*W*3]; returns the stacked output
        tensors on the device (asynchronous on the card). The call is the
        profiler range "chunk", the parent of the stages' ranges."""
        with _span("chunk"), torch.inference_mode():
            k = frames_flat.shape[0]
            self.state, outs = self.chunk_body(k, h, w)(self.state,
                                                       frames_flat)
            self.timing["frames"] += k
        return outs

    def process_chunk(self, frames_bgr: np.ndarray):
        """Run a chunk of frames [K, H, W, 3] uint8 BGR; returns the
        stacked output tensors on the device, with a leading K axis."""
        k, h, w = frames_bgr.shape[:3]
        return self.process_chunk_device(self.stage_chunk(frames_bgr), h, w)

    def fetch_chunk_outputs(self, outs, frame_w: int, frame_h: int):
        """A chunk's outputs -> a list per frame of fetch_outputs' lists.
        The output tensors are packed on the device into one int32 tensor
        (pack_outputs), so that the chunk makes one device-to-host copy;
        the host unpacks it by views. The call is the profiler range
        "fetch": the copy, which waits for the chunk, in "fetch.copy",
        then the per-frame lists (chunk_tracks) in "fetch.tracks"."""
        with _span("fetch"):
            with _span("fetch.copy"):
                host = unpack_outputs(pack_outputs(outs).cpu().numpy())
            with _span("fetch.tracks"):
                return chunk_tracks(host["ids"], host["scores"],
                                    host["poses"], host["boxes"],
                                    host["emit"], frame_w, frame_h,
                                    self.config.detector.input_size)

    def prestage_frame(self, frame_bgr: np.ndarray) -> torch.Tensor:
        """Start the copy of one frame to the device, so that it overlaps
        the frame being computed; returns the flat device tensor for
        process_frame_device."""
        return self._stage(frame_bgr, (-1,))

    def process_frame_device(self, frame_flat: torch.Tensor, h: int, w: int,
                             block: bool = False):
        """Run the per-frame step on a staged frame [H*W*3]. The call is
        the profiler range "frame", the parent of the stages' ranges."""
        with _span("frame"):
            with torch.inference_mode():
                self.state, out = self._step(frame_flat, h, w)
            if block and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.timing["frames"] += 1
        return out

    def process_stream(self, frames, sync_depth: int = 2):
        """Depth-pipelined streaming: yields the device outputs of each
        frame of an iterable, keeping up to `sync_depth` frames in flight.
        Frame N+1's copy is issued before frame N's outputs are awaited;
        waiting on the oldest frame in flight bounds the queue, and every
        yielded output is complete."""
        from collections import deque

        def ready(out):
            if out["done"] is not None:
                out["done"].synchronize()
            return {k: v for k, v in out.items() if k != "done"}

        def run(staged):
            out = self.process_frame_device(*staged)
            out["done"] = None
            if self.device.type == "cuda":
                out["done"] = torch.cuda.Event()
                out["done"].record()
            return out

        inflight: deque = deque()
        staged = None
        for frame in frames:
            h, w = frame.shape[:2]
            nxt = self.prestage_frame(frame)
            if staged is not None:
                inflight.append(run(staged))
                if len(inflight) > sync_depth:
                    yield ready(inflight.popleft())
            staged = (nxt, h, w)
        if staged is not None:
            inflight.append(run(staged))
        while inflight:
            yield ready(inflight.popleft())

    def process_frame(self, frame_bgr: np.ndarray, block: bool = False):
        """Run one frame (uint8 HWC BGR); returns the output tensors on the
        device. Asynchronous on the card unless block=True. The frame goes
        to the device by a plain (pageable) copy; process_stream's
        prestage_frame pins it so that the copy overlaps compute."""
        h, w = frame_bgr.shape[:2]
        t0 = time.perf_counter()
        flat = torch.from_numpy(
            np.ascontiguousarray(frame_bgr, dtype=np.uint8).reshape(-1))
        with _span("ingest"):
            flat = flat.to(self.device)
        out = self.process_frame_device(flat, h, w, block)
        self.timing["dispatch_ms"] += (time.perf_counter() - t0) * 1e3
        return out

    def fetch_outputs(self, out, frame_w: int, frame_h: int):
        """The one device-to-host copy: outputs -> list of TrackOutput in
        frame coordinates. The profiler ranges are fetch_chunk_outputs'."""
        with _span("fetch"):
            with _span("fetch.copy"):
                ids, scores, poses, boxes, emit = (
                    out[k].cpu().numpy()
                    for k in ("ids", "scores", "poses", "boxes", "emit"))
            with _span("fetch.tracks"):
                return frame_tracks(ids, scores, poses, boxes, emit, frame_w,
                                    frame_h, self.config.detector.input_size)

    def reset(self):
        trk_cfg = self.config.tracker
        self.state = TrackerState.init(trk_cfg.max_tracks,
                                       trk_cfg.max_detections, self.device)

    @property
    def mean_frame_ms(self) -> float:
        f = max(self.timing["frames"], 1)
        return self.timing["dispatch_ms"] / f

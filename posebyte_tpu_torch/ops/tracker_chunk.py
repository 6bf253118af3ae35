"""The tracker recurrence over a chunk of K frames, after
posebyte_tpu/ops/pallas_tracker.py::tracker_chunk_pallas.

    tracker_chunk(state, dets, config, advance=None, det_embeddings=None)
        -> (state', outs)

dets is a Detections with a leading K axis (poses [K, D, 17, 3], boxes
[K, D, 4], scores [K, D], valid [K, D]); outs holds per frame ids [K, D]
int32, scores [K, D], poses [K, D, 17, 3], boxes [K, D, 4], emit [K, D]
bool and num_active [K] int32. advance is an optional [K] bool mask: a
frame with advance False leaves the state untouched and reports ids -1,
scores 0, emit False and num_active 0 (its poses and boxes are those of
the would-be state, as the TPU kernel gives them). A leading stream axis S
on the state's fields, the detections and advance runs S independent
streams (the JAX package vmaps the kernel over streams).

det_embeddings ([K, D, 51] float32, or [S, K, D, 51]) are the detections'
appearance embeddings (ops/reid.py): required when config.reid_weight > 0
and refused when it is 0, as the TPU kernel asserts. The state's
embeddings then follow the tracks like every other field.

With config.motion_model "kalman136" the state's kf_mean and kf_cov
[T, 136] (the third-order filter, ops/kalman.py::Kalman136) follow the
tracks like every other field; with "cv" they pass through unchanged.

tracker_chunk_cuda is Kernel 3 (csrc/tracker_chunk.cu), one launch per
chunk with one block per stream, for either motion model, with or without
Re-ID, with the torso tier. Its optional stage_cycles ([S, CLOCK_COLUMNS]
int64 on the card, or [CLOCK_COLUMNS] for one stream) is the kernel's
stage clock: the launch adds each stage's clock cycles, in the order of
STAGES, then each tier's auction rounds and the frames in which a tier
used its whole round budget; read_stage_clock turns it into a split.
tracker_chunk_plain is its plain version, a loop of tracker_step and
extract_outputs_device with the advance blend of the serving scan, which
also runs torso_tier=False. The dispatcher
tracker_chunk takes the kernel for CUDA tensors and the plain version for
CPU tensors only.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core import constants as C
from ..core.config import TrackerConfig
from ..core.structs import Detections, TrackerState
from . import cuda_lib
from .assignment import _MAX_SMEM, auction_iterations
from .kalman import CV_LOST_DECAY, CV_MEASUREMENT_NOISE, CV_PROCESS_NOISE, \
    CV_VELOCITY_ALPHA, _PROCESS_NOISE_DIAG
from .oks import _sig_sq

OUT_KEYS = ("ids", "scores", "poses", "boxes", "emit", "num_active")
# The stage clock's columns (csrc/tracker_chunk.cu, enum Stage): cycles
# per stage, then rounds per tier (3), then frames at the round budget per
# tier (3). "state" is the pool's load and store, and the save and restore
# around a frame that does not advance.
STAGES = ("state", "detections", "predict", "centres", "gate_tier1_cost",
          "tier1_auction", "tier2", "tier3", "update", "births", "dedup",
          "outputs")
CLOCK_COLUMNS = len(STAGES) + 6
# State fields the kernel carries in its table of state pointers, with
# their dtypes (the embeddings pass through unchanged without Re-ID).
# kf_mean and kf_cov have pointers of their own at the end of the table,
# null for cv, whose wrapper hands the input's filter through.
_CARRIED = (("poses", torch.float32), ("velocities", torch.float32),
            ("scores", torch.float32), ("ids", torch.int32),
            ("states", torch.int32), ("hits", torch.int32),
            ("ages", torch.int32), ("last_frame", torch.int32),
            ("active", torch.bool), ("embeddings", torch.float32))


def _check_options(config: TrackerConfig, det_embeddings, what: str,
                   kernel: bool) -> None:
    if kernel and not config.torso_tier:
        raise NotImplementedError(f"{what}: the kernel always runs the "
                                  "torso tier (torso_tier=True)")
    if (det_embeddings is not None) != (config.reid_weight > 0.0):
        raise ValueError(f"{what}: det_embeddings must be given exactly "
                         "when config.reid_weight > 0")


def _pick(obj, i):
    """Field-wise obj[i] of a Detections or TrackerState."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name)[i] for f in dataclasses.fields(obj)})


def _stack(objs):
    return dataclasses.replace(objs[0], **{
        f.name: torch.stack([getattr(o, f.name) for o in objs])
        for f in dataclasses.fields(objs[0])})


def _plain_one_stream(state: TrackerState, dets: Detections,
                      config: TrackerConfig, advance, det_embeddings):
    # Imported here: tracker.step imports ops, whose package imports this
    # module, so a module-level import of the tracker is circular.
    from ..tracker.output import extract_outputs_device
    from ..tracker.step import tracker_step
    outs = {k: [] for k in OUT_KEYS}
    for k in range(dets.scores.shape[0]):
        det = _pick(dets, k)
        new, aux = tracker_step(
            state, det, config,
            None if det_embeddings is None else det_embeddings[k])
        ids, scores, poses, boxes, emit = extract_outputs_device(
            new, det.scores, config)
        num_active = aux["num_active"].to(torch.int32)
        if advance is not None:
            adv = advance[k]
            state = dataclasses.replace(state, **{
                f.name: torch.where(adv, getattr(new, f.name),
                                    getattr(state, f.name))
                for f in dataclasses.fields(state)})
            ids = torch.where(adv, ids, -1)
            scores = torch.where(adv, scores, 0.0)
            emit = emit & adv
            num_active = torch.where(adv, num_active, 0)
        else:
            state = new
        for key, v in zip(OUT_KEYS, (ids, scores, poses, boxes, emit,
                                     num_active)):
            outs[key].append(v)
    return state, {k: torch.stack(v) for k, v in outs.items()}


def tracker_chunk_plain(state: TrackerState, dets: Detections,
                        config: TrackerConfig = TrackerConfig(),
                        advance: torch.Tensor | None = None,
                        det_embeddings: torch.Tensor | None = None):
    """Plain version of Kernel 3: tracker_step and extract_outputs_device
    frame by frame (on a CUDA tensor its auctions run through Kernel 2)."""
    _check_options(config, det_embeddings, "tracker_chunk_plain",
                   kernel=False)
    if dets.poses.dim() == 4:
        return _plain_one_stream(state, dets, config, advance,
                                 det_embeddings)
    results = [_plain_one_stream(
        _pick(state, s), _pick(dets, s), config,
        None if advance is None else advance[s],
        None if det_embeddings is None else det_embeddings[s])
        for s in range(dets.poses.shape[0])]
    return (_stack([r[0] for r in results]),
            {k: torch.stack([r[1][k] for r in results]) for k in OUT_KEYS})


def _float_args(config: TrackerConfig, T: int) -> np.ndarray:
    """The kernel's float constants, rounded to float32 as the plain
    version's PyTorch operations round their Python scalars."""
    gain = CV_MEASUREMENT_NOISE / (CV_MEASUREMENT_NOISE + CV_PROCESS_NOISE)
    cpu = torch.device("cpu")
    return np.concatenate([
        np.asarray([config.gate_threshold,
                    config.gate_threshold * C.LOST_GATE_SCALE,
                    config.visibility_threshold, config.dedup_iou_threshold,
                    config.new_track_thresh, gain, CV_VELOCITY_ALPHA,
                    1.0 - CV_VELOCITY_ALPHA, CV_LOST_DECAY,
                    1.0 / (T + 1)], np.float64)
        .astype(np.float32),
        _sig_sq(2.0, False, cpu).numpy(), _sig_sq(3.0, True, cpu).numpy(),
        np.asarray([config.reid_weight, 1.0 - config.reid_weight,
                    config.reid_ema, 1.0 - config.reid_ema,
                    config.accel_memory, config.jerk_memory, 1.0 / 6.0],
                   np.float64).astype(np.float32),
        _PROCESS_NOISE_DIAG[:8:2],          # p, v, a, j: float32 squares
    ]).astype(np.float32)


def read_stage_clock(stage_cycles: torch.Tensor, frames: int,
                     ms_per_frame: float | None = None) -> dict:
    """The split of a stage clock summed over `frames` stream-frames:
    cycles per frame and share of each stage, auction rounds per frame and
    the share of frames at the round budget per tier, and with the
    kernel's measured ms per frame of one stream the us per frame of each
    stage (its share of that time)."""
    c = [int(v) for v in stage_cycles.reshape(-1, CLOCK_COLUMNS).sum(0)]
    n = len(STAGES)
    total = sum(c[:n]) or 1
    out = {"cycles_per_frame": {s: c[i] / frames
                                for i, s in enumerate(STAGES)},
           "share": {s: c[i] / total for i, s in enumerate(STAGES)},
           "rounds_per_frame": [c[n + t] / frames for t in range(3)],
           "budget_share": [c[n + 3 + t] / frames for t in range(3)]}
    if ms_per_frame is not None:
        out["us_per_frame"] = {s: c[i] / total * ms_per_frame * 1e3
                               for i, s in enumerate(STAGES)}
    return out


def smem_bytes(T: int, D: int, reid: bool) -> int:
    """Shared memory of one Kernel 3 block (the kernel's own layout)."""
    return cuda_lib.load().posebyte_tracker_chunk_smem_bytes(T, D, int(reid))


def tracker_chunk_cuda(state: TrackerState, dets: Detections,
                       config: TrackerConfig = TrackerConfig(),
                       advance: torch.Tensor | None = None,
                       det_embeddings: torch.Tensor | None = None,
                       stage_cycles: torch.Tensor | None = None):
    """Kernel 3 on CUDA tensors: one launch for the whole chunk, one block
    per stream; with stage_cycles its stage clock is added into that
    tensor (the outputs are the same). Raises on a CPU tensor, a bad shape
    or dtype, an option that is not ported, or a launch error."""
    _check_options(config, det_embeddings, "tracker_chunk_cuda", kernel=True)
    reid = det_embeddings is not None
    kalman = config.motion_model == "kalman136"
    single = dets.poses.dim() == 4
    if single:
        state, dets = _stack([state]), _stack([dets])
        advance = None if advance is None else advance[None]
        det_embeddings = None if not reid else det_embeddings[None]
        stage_cycles = None if stage_cycles is None else stage_cycles[None]
    dev = dets.poses.device
    tensors = [getattr(dets, f.name) for f in dataclasses.fields(dets)] + \
        [getattr(state, f.name) for f in dataclasses.fields(state)]
    tensors += [t for t in (advance, det_embeddings, stage_cycles)
                if t is not None]
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("tracker_chunk_cuda: all inputs must be on one "
                         "CUDA device")
    if dets.poses.dim() != 5:
        raise ValueError("tracker_chunk_cuda: dets.poses must be [K, D, 17, "
                         "3] or [S, K, D, 17, 3]")
    S, K, D = dets.poses.shape[:3]
    T = state.poses.shape[1]
    E = C.NUM_KEYPOINTS * 3
    shapes = {
        "dets.poses": (dets.poses, (S, K, D, C.NUM_KEYPOINTS, 3)),
        "dets.scores": (dets.scores, (S, K, D)),
        "dets.valid": (dets.valid, (S, K, D)),
        "state.poses": (state.poses, (S, T, C.NUM_KEYPOINTS, 3)),
        "state.velocities": (state.velocities, (S, T, C.NUM_KEYPOINTS, 2)),
        "state.embeddings": (state.embeddings, (S, T, E)),
        "state.next_id": (state.next_id, (S,)),
        "state.frame": (state.frame, (S,)),
        "state.det_track_slot": (state.det_track_slot, (S, D)),
        "state.kf_mean": (state.kf_mean, (S, T, C.TOTAL_STATE_DIM)),
        "state.kf_cov": (state.kf_cov, (S, T, C.TOTAL_STATE_DIM)),
    }
    shapes.update({f"state.{n}": (getattr(state, n), (S, T))
                   for n in ("scores", "ids", "states", "hits", "ages",
                             "last_frame", "active")})
    if (T, D) != (config.max_tracks, config.max_detections):
        raise ValueError(f"tracker_chunk_cuda: T={T}, D={D}, but the config "
                         f"says {config.max_tracks}, {config.max_detections}")
    if advance is not None:
        shapes["advance"] = (advance, (S, K))
    if reid:
        shapes["det_embeddings"] = (det_embeddings, (S, K, D, E))
    if stage_cycles is not None:
        shapes["stage_cycles"] = (stage_cycles, (S, CLOCK_COLUMNS))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"tracker_chunk_cuda: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    dtypes = [(dets.poses, torch.float32), (dets.scores, torch.float32),
              (dets.valid, torch.bool), (state.next_id, torch.int32),
              (state.frame, torch.int32),
              (state.det_track_slot, torch.int32),
              (state.kf_mean, torch.float32),
              (state.kf_cov, torch.float32)] + \
        [(getattr(state, n), dt) for n, dt in _CARRIED]
    if advance is not None:
        dtypes.append((advance, torch.bool))
    if reid:
        dtypes.append((det_embeddings, torch.float32))
    if stage_cycles is not None:
        dtypes.append((stage_cycles, torch.int64))
        if not stage_cycles.is_contiguous():
            raise ValueError("tracker_chunk_cuda: stage_cycles must be "
                             "contiguous (the kernel adds into it)")
    if any(t.dtype != dt for t, dt in dtypes):
        raise TypeError("tracker_chunk_cuda: float32 poses, velocities, "
                        "scores, embeddings and filter, int32 counters and "
                        "ids, bool valid, active and advance, int64 "
                        "stage_cycles")
    if min(S, K, T, D) <= 0 or smem_bytes(T, D, reid) > _MAX_SMEM:
        raise ValueError(f"tracker_chunk_cuda: T={T}, D={D} does not fit "
                         "one block's shared memory"
                         + (" with Re-ID" if reid else ""))

    if advance is None:
        advance = torch.ones((S, K), dtype=torch.bool, device=dev)
    counters = torch.stack([state.next_id, state.frame], dim=-1)
    ins_state = [getattr(state, n).contiguous() for n, _ in _CARRIED] + \
        [counters, state.det_track_slot.contiguous()]
    ins = [t.contiguous() for t in (dets.poses, dets.scores, dets.valid,
                                    advance)]
    ins.append(det_embeddings.contiguous() if reid else None)
    outs_state = [torch.empty_like(t) for t in ins_state]
    outs = {"ids": torch.empty((S, K, D), dtype=torch.int32, device=dev),
            "scores": torch.empty((S, K, D), dtype=torch.float32,
                                  device=dev),
            "poses": torch.empty((S, K, D, C.NUM_KEYPOINTS, 3),
                                 dtype=torch.float32, device=dev),
            "boxes": torch.empty((S, K, D, 4), dtype=torch.float32,
                                 device=dev),
            "emit": torch.empty((S, K, D), dtype=torch.bool, device=dev),
            "num_active": torch.empty((S, K), dtype=torch.int32,
                                      device=dev)}
    # kalman136: the filter in and out, and the scratch copy of the frames
    # that do not advance (the kernel allocates nothing)
    kf = [None] * 5
    if kalman:
        kf_in = [state.kf_mean.contiguous(), state.kf_cov.contiguous()]
        kf = kf_in + [torch.empty_like(t) for t in kf_in] + [torch.empty(
            (S, 2, T, C.TOTAL_STATE_DIM), dtype=torch.float32, device=dev)]
    table = ins + ins_state + outs_state + list(outs.values()) + kf + \
        [stage_cycles]
    ptrs = (ctypes.c_void_p * len(table))(
        *(None if t is None else t.data_ptr() for t in table))
    iargs = np.asarray([S, K, T, D, config.min_hits, config.max_age,
                        config.max_age + config.lost_window,
                        auction_iterations(T), C.TENTATIVE_MAX_AGE,
                        int(reid), int(kalman)], np.int32)
    fargs = _float_args(config, T)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.posebyte_tracker_chunk(ptrs, iargs.ctypes.data,
                                            fargs.ctypes.data, stream)
    cuda_lib.check(status, "tracker_chunk")
    tracker_chunk_cuda.launches += 1

    new = dict(zip((n for n, _ in _CARRIED), outs_state[:len(_CARRIED)]))
    counters, slot = outs_state[len(_CARRIED):]
    kf_mean, kf_cov = kf[2:4] if kalman else (state.kf_mean, state.kf_cov)
    new_state = TrackerState(
        **new, next_id=counters[:, 0], frame=counters[:, 1],
        det_track_slot=slot, kf_mean=kf_mean, kf_cov=kf_cov)
    if single:
        return _pick(new_state, 0), {k: v[0] for k, v in outs.items()}
    return new_state, outs


tracker_chunk_cuda.launches = 0


def tracker_chunk(state: TrackerState, dets: Detections,
                  config: TrackerConfig = TrackerConfig(),
                  advance: torch.Tensor | None = None,
                  det_embeddings: torch.Tensor | None = None):
    """K tracker frames: Kernel 3 for CUDA tensors, the plain version for
    CPU tensors."""
    if dets.poses.is_cuda:
        return tracker_chunk_cuda(state, dets, config, advance,
                                  det_embeddings)
    if dets.poses.device.type != "cpu":
        raise ValueError(f"tracker_chunk: unsupported device "
                         f"{dets.poses.device}")
    return tracker_chunk_plain(state, dets, config, advance, det_embeddings)

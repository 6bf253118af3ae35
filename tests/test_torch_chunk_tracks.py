"""runner.chunk_tracks, the chunk-wide un-letterbox of fetch_chunk_outputs,
against the per-frame loop it replaced (kept here as the oracle): the same
TrackOutputs, ids, scores and the bits of every bbox and keypoint, in the
same order, from the same packed host copy.

- Emit patterns: no frame emits, every slot emits, uneven counts with
  empty frames between, one frame (K = 1, frame_tracks' case); each on
  1280x720, 1920x1080 and 720x1280 frames.
- fetch_chunk_outputs and frame_tracks return the oracle's lists.
- Each track's bbox and keypoints share memory with nothing: writing one
  leaves the packed host array and the other tracks as they were.
"""
import numpy as np
import pytest
import torch

from posebyte_tpu_torch.core.config import DetectorConfig, PipelineConfig
from posebyte_tpu_torch.ops.preprocess import letterbox_params
from posebyte_tpu_torch.pipeline import runner
from posebyte_tpu_torch.tracker.output import (TrackOutput, pack_outputs,
                                               unpack_outputs)

D, INPUT = 64, 640
SIZES = [(1280, 720), (1920, 1080), (720, 1280)]


def loop_tracks(ids, scores, poses, boxes, emit, frame_w, frame_h,
                input_size):
    """The per-frame loop fetch_chunk_outputs ran before chunk_tracks."""
    scale, _, _, pad_x, pad_y = letterbox_params(frame_w, frame_h,
                                                 input_size)
    pad = np.asarray([pad_x, pad_y], np.float32)
    results = []
    for d in range(len(ids)):
        if not emit[d]:
            continue
        kp = poses[d].copy()
        kp[:, :2] = (kp[:, :2] - pad) / scale
        bb = boxes[d].copy()
        bb[0:2] = (bb[0:2] - pad) / scale
        bb[2:4] = (bb[2:4] - pad) / scale
        results.append(TrackOutput(track_id=int(ids[d]),
                                   score=float(scores[d]),
                                   bbox=bb, keypoints=kp))
    return results


def emit_pattern(name, rng):
    if name == "none":
        return np.zeros((8, D), bool)
    if name == "all":
        return np.ones((8, D), bool)
    if name == "uneven":
        emit = np.zeros((9, D), bool)
        for f, n in zip(range(9), (3, 0, 0, 1, 17, 0, 64, 6, 0)):
            emit[f, rng.choice(D, n, replace=False)] = True
        return emit
    emit = np.zeros((1, D), bool)                      # "one_frame"
    emit[0, rng.choice(D, 6, replace=False)] = True
    return emit


def device_outputs(emit, rng):
    """Output tensors as the chunk path leaves them, with leading [K, D]:
    letterboxed poses and boxes around the 640 input, rounding-prone
    fractions among them."""
    k = emit.shape[0]
    poses = rng.uniform(-20.0, 660.0, (k, D, 17, 3)).astype(np.float32)
    poses[..., 2] = rng.uniform(0.0, 1.0, (k, D, 17))
    poses[:, :, 0, :2] = np.float32(1) / 3          # ties to rounding
    boxes = rng.uniform(-50.0, 690.0, (k, D, 4)).astype(np.float32)
    ids = np.where(emit, rng.integers(1, 10_000, (k, D)), -1)
    scores = np.where(emit, rng.uniform(0.25, 1.0, (k, D)), 0.0)
    return {"ids": torch.from_numpy(ids.astype(np.int32)),
            "scores": torch.from_numpy(scores.astype(np.float32)),
            "poses": torch.from_numpy(poses),
            "boxes": torch.from_numpy(boxes),
            "emit": torch.from_numpy(emit),
            "num_active": torch.from_numpy(emit.sum(1).astype(np.int32))}


def host_copy(outs):
    return unpack_outputs(pack_outputs(outs).numpy())


def bits(lists):
    """TrackOutputs -> (id, score, bbox bits, keypoint bits) per track, with
    the types and shapes the loop gives, nested by frame."""
    return [[(type(t.track_id), t.track_id, type(t.score), t.score,
              t.bbox.dtype, t.bbox.shape, t.bbox.view(np.int32).tolist(),
              t.keypoints.dtype, t.keypoints.shape,
              t.keypoints.view(np.int32).tolist()) for t in frame]
            for frame in lists]


def loop_chunk(host, frame_w, frame_h):
    return [loop_tracks(*(host[n][i] for n in
                          ("ids", "scores", "poses", "boxes", "emit")),
                        frame_w, frame_h, INPUT)
            for i in range(len(host["ids"]))]


def chunk(host, frame_w, frame_h):
    return runner.chunk_tracks(host["ids"], host["scores"], host["poses"],
                               host["boxes"], host["emit"], frame_w,
                               frame_h, INPUT)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("pattern", ["none", "all", "uneven", "one_frame"])
def test_chunk_tracks_equal_the_loop(pattern, size):
    rng = np.random.default_rng([len(pattern), *size])
    emit = emit_pattern(pattern, rng)
    host = host_copy(device_outputs(emit, rng))
    want = loop_chunk(host, *size)
    got = chunk(host, *size)
    assert len(got) == emit.shape[0]
    assert [len(f) for f in got] == emit.sum(1).tolist()
    assert bits(got) == bits(want)
    if pattern == "one_frame":
        one = runner.frame_tracks(*(host[n][0] for n in
                                    ("ids", "scores", "poses", "boxes",
                                     "emit")), *size, INPUT)
        assert bits([one]) == bits(want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_fetch_chunk_outputs_equal_the_loop(size):
    """The pipeline's fetch on the packed tensors: the loop's lists."""
    rng = np.random.default_rng(7)
    outs = device_outputs(emit_pattern("uneven", rng), rng)

    class Pipe:
        config = PipelineConfig(detector=DetectorConfig(input_size=INPUT))

    got = runner.PosePipeline.fetch_chunk_outputs(Pipe(), outs, *size)
    assert bits(got) == bits(loop_chunk(host_copy(outs), *size))


def test_tracks_share_no_memory():
    rng = np.random.default_rng(3)
    emit = emit_pattern("uneven", rng)
    packed = pack_outputs(device_outputs(emit, rng)).numpy()
    before = packed.copy()
    host = unpack_outputs(packed)
    tracks = [t for f in chunk(host, 1280, 720) for t in f]
    arrays = [a for t in tracks for a in (t.bbox, t.keypoints)]
    for i, a in enumerate(arrays):
        assert not np.shares_memory(a, packed)
        assert not any(np.shares_memory(a, b) for b in arrays[i + 1:])
    want = bits([tracks[1:]])
    tracks[0].bbox[:] = -1.0
    tracks[0].keypoints[:] = -1.0
    assert np.array_equal(packed, before)
    assert bits([tracks[1:]]) == want

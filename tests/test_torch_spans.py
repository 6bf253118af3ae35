"""The port's profiler ranges (pipeline/runner.py, named in
utils/profiling.py's STAGES) on the CPU profiler: two chunks of 4 frames
of 640x360 through process_chunk_device and fetch_chunk_outputs, and one
frame through process_frame and fetch_outputs.

- "chunk" holds the stages' ranges and every operation of the call; the
  n-th "chunk" ends before the n-th "fetch" starts.
- "fetch" holds "fetch.copy" then "fetch.tracks", and every operation of
  the call lies in one of them; chunk_tracks runs once a fetch, inside
  "fetch.tracks".
- "frame" holds the per-frame stages, "ingest" stays outside it.
- Every user annotation the port opens is in STAGES, and a parent's
  children are those PARENTS gives.
- The fetched lists are equal with and without the profiler.
"""
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from posebyte_tpu_torch.core.config import DetectorConfig, PipelineConfig
from posebyte_tpu_torch.models import load_params
from posebyte_tpu_torch.pipeline import PosePipeline, runner
from posebyte_tpu_torch.utils.profiling import PARENTS, STAGES
from posebyte_tpu_torch.utils.synthetic import SyntheticScene, render_frame

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "yolov8n-pose-synthetic256.safetensors")
W, H, K = 640, 360, 4
PROBE = "test.chunk_tracks"          # the test's own range, not the port's


@pytest.fixture(scope="module")
def params():
    return load_params(ASSET)[0]


@pytest.fixture(scope="module")
def frames():
    scene = SyntheticScene(4, W, H, seed=5)
    return np.stack([render_frame(scene.step(), W, H)
                     for _ in range(2 * K + 1)])


def pipeline(params):
    return PosePipeline(PipelineConfig(
        detector=DetectorConfig(input_size=256, num_anchors=1344),
        precision="fp32"), params=params, device="cpu")


def run(pipe, frames):
    """Two chunks, then one frame; the fetched lists."""
    got = []
    for c in range(2):
        staged = pipe.stage_chunk(frames[c * K:(c + 1) * K])
        outs = pipe.process_chunk_device(staged, H, W)
        got.append(pipe.fetch_chunk_outputs(outs, W, H))
    got.append(pipe.fetch_outputs(pipe.process_frame(frames[2 * K]), W, H))
    return got


def flat(results):
    """TrackOutputs -> comparable tuples, nested as fetched."""
    if isinstance(results, list):
        return [flat(r) for r in results]
    return (results.track_id, results.score, results.bbox.tolist(),
            results.keypoints.tolist())


@pytest.fixture(scope="module")
def traced(params, frames):
    """The run under the CPU profiler, chunk_tracks wrapped in a range of
    the test's own; (the host events as (start, end, name, thread), the
    fetched lists)."""
    pipe = pipeline(params)
    orig = runner.chunk_tracks

    def probed(*args, **kwargs):
        with record_function(PROBE):
            return orig(*args, **kwargs)

    runner.chunk_tracks = probed
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = run(pipe, frames)
    finally:
        runner.chunk_tracks = orig
    events = [(e.time_range.start, e.time_range.end, e.name, e.thread,
               bool(e.is_user_annotation)) for e in prof.events()]
    return events, got


def spans(events, name):
    return sorted((s, e, t) for s, e, n, t, _ in events if n == name)


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1] \
        and inner[2] == outer[2]


def ops_within(events, span):
    return [(s, e, t) for s, e, n, t, ann in events
            if not ann and n.startswith("aten::")
            and inside((s, e, t), span)]


def test_every_user_annotation_is_in_the_table(traced):
    events, _ = traced
    names = {n for _, _, n, _, ann in events if ann} - {PROBE}
    assert names <= set(STAGES), names - set(STAGES)
    assert {"chunk", "frame", "fetch", "fetch.copy", "fetch.tracks",
            "ingest", "letterbox", "model", "decode", "nms", "tracker",
            "outputs"} <= names
    assert set(PARENTS) <= set(STAGES)
    assert all(set(c) <= set(STAGES) for c in PARENTS.values())


def test_span_refuses_a_name_outside_the_table():
    with pytest.raises(ValueError, match="not in STAGES"):
        runner._span("unpack")


def test_chunk_holds_its_stages_and_operations(traced):
    events, _ = traced
    chunks = spans(events, "chunk")
    assert len(chunks) == 2
    for c in chunks:
        kids = {n for n in PARENTS["chunk"]
                if any(inside(s, c) for s in spans(events, n))}
        assert kids == {"letterbox", "model", "decode", "nms", "tracker"}
        stages = [s for n in PARENTS["chunk"] for s in spans(events, n)
                  if inside(s, c)]
        ops = ops_within(events, c)
        assert ops
        assert all(any(inside(o, s) for s in stages) for o in ops)
    # every chunk-path stage lies in a chunk or the frame
    holders = chunks + spans(events, "frame")
    for n in PARENTS["chunk"]:
        assert all(any(inside(s, h) for h in holders)
                   for s in spans(events, n))


def test_fetch_holds_copy_then_tracks(traced):
    events, _ = traced
    fetches = spans(events, "fetch")
    assert len(fetches) == 3                 # two chunks, one frame
    probes = spans(events, PROBE)
    assert len(probes) == len(fetches)     # one call a fetch
    for f in fetches:
        copy = [s for s in spans(events, "fetch.copy") if inside(s, f)]
        tracks = [s for s in spans(events, "fetch.tracks") if inside(s, f)]
        assert len(copy) == len(tracks) == 1
        assert copy[0][1] <= tracks[0][0]
        assert all(any(inside(o, s) for s in copy + tracks)
                   for o in ops_within(events, f))
        assert sum(inside(p, tracks[0]) for p in probes) == 1
    assert all(any(inside(p, t) for t in spans(events, "fetch.tracks"))
               for p in probes)


def test_nth_chunk_precedes_nth_fetch(traced):
    events, _ = traced
    chunks, fetches = spans(events, "chunk"), spans(events, "fetch")[:2]
    for c, f in zip(chunks, fetches):
        assert c[1] <= f[0]
    assert chunks[1][0] >= fetches[0][1]     # one chunk in flight


def test_frame_holds_its_stages(traced):
    events, _ = traced
    (frame,) = spans(events, "frame")
    kids = {n for n in PARENTS["frame"]
            if any(inside(s, frame) for s in spans(events, n))}
    assert kids == {"letterbox", "model", "decode", "nms", "tracker",
                    "outputs"}
    assert not any(inside(s, frame) for s in spans(events, "ingest"))
    assert not any(inside(s, frame) for s in spans(events, "chunk"))


def test_fetched_lists_equal_without_the_profiler(traced, params, frames):
    _, got = traced
    want = run(pipeline(params), frames)
    assert flat(got) == flat(want)
    assert sum(len(f) for f in want[1]) > 0  # the people are tracked

"""The idle readers, unpack_idle_ms and enqueue_idle_ms, on hand-built
traces: the gaps under the program's ranges a chunk, None untraced and
where the program's table of range names lacks them; and the trace's
reduction putting a gap under the innermost of nested ranges."""
import types

import pytest
import torch

from portbench.harness import spec
from portbench.harness import trace as TR
from portbench.harness.context import Context
from posebyte_tpu_torch.utils import profiling

UNPACK = spec.load_module("metrics", "unpack_idle_ms")
ENQUEUE = spec.load_module("metrics", "enqueue_idle_ms")
OLD_STAGES = ("ingest", "letterbox", "model", "decode", "nms", "reid",
              "tracker", "outputs", "fetch")


def ctx(gaps, chunks=4, busy=1.0):
    c = Context({}, {}, 1.0, 0.0, [(0.0, 0.1, 0.2, 128)] * chunks,
                range(chunks))
    c.trace = TR.Trace(2.0, busy, busy, {}, {}, gaps, 128 * chunks, chunks)
    return c


GAPS = {"fetch.tracks": 0.040, "fetch": 0.002, "fetch.copy": 0.001,
        "chunk": 0.0004, "model": 0.0012, "tracker": 0.0002,
        "letterbox": 0.0001, "bench.fetch_chunk_outputs": 0.0003,
        "no_stage": 0.00001}


def test_unpack_idle_reads_the_tracks_gap_a_chunk():
    assert UNPACK.read(ctx(GAPS)) == pytest.approx(10.0)


def test_enqueue_idle_reads_chunk_and_its_stages():
    assert ENQUEUE.read(ctx(GAPS)) == pytest.approx(
        1e3 * (0.0004 + 0.0012 + 0.0002 + 0.0001) / 4)


def test_idle_reads_zero_where_no_gap_fell_under_the_ranges():
    assert UNPACK.read(ctx({"fetch": 0.01})) == 0.0
    assert ENQUEUE.read(ctx({"fetch": 0.01})) == 0.0


@pytest.mark.parametrize("reader", [UNPACK, ENQUEUE],
                         ids=["unpack", "enqueue"])
def test_idle_is_none_untraced(reader):
    c = ctx(GAPS)
    c.trace = None
    assert reader.read(c) is None
    assert reader.read(ctx(GAPS, busy=0.0)) is None


@pytest.mark.parametrize("reader", [UNPACK, ENQUEUE],
                         ids=["unpack", "enqueue"])
def test_idle_is_none_where_the_program_lacks_the_ranges(reader,
                                                         monkeypatch):
    """A program from before the ranges (its table as it was) reads None,
    and one with no table at all does not raise."""
    monkeypatch.setattr(profiling, "STAGES", OLD_STAGES)
    assert reader.read(ctx(GAPS)) is None
    monkeypatch.delattr(profiling, "STAGES")
    assert reader.read(ctx(GAPS)) is None


def event(name, start, end, cuda=False, annotation=False):
    kind = torch.autograd.DeviceType
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=kind.CUDA if cuda else kind.CPU,
        is_user_annotation=annotation,
        device_time_total=0.0)


def test_gap_goes_under_the_innermost_nested_range():
    """fetch holds fetch.copy then fetch.tracks, inside the benchmark's
    span: the gap after the copy goes to fetch.tracks, the one inside the
    chunk's enqueue to its stage, the one between the two stages of the
    chunk to chunk."""
    prof = types.SimpleNamespace(events=lambda: [
        event(TR.SPAN_CALL, 0, 100, annotation=True),
        event("chunk", 1, 99, annotation=True),
        event("model", 2, 50, annotation=True),
        event("tracker", 60, 98, annotation=True),
        event(TR.SPAN_FETCH, 100, 300, annotation=True),
        event("fetch", 101, 299, annotation=True),
        event("fetch.copy", 102, 150, annotation=True),
        event("fetch.tracks", 151, 298, annotation=True),
        event("fetch.tracks", 10, 290, cuda=True, annotation=True),
        event("k1", 5, 20, cuda=True),       # gap 20-30 under model
        event("k2", 30, 52, cuda=True),      # gap 52-62 under chunk
        event("k3", 62, 145, cuda=True),     # gap 145-160: tracks
        event("memcpy", 160, 162, cuda=True),  # gap 162-300: tracks
        event("k4", 300, 310, cuda=True),
    ])
    t = TR.reduce(prof, {"model", "tracker", "fetch"}, 1.0, 128, 1)
    assert t.gaps == pytest.approx({"model": 10e-6, "chunk": 10e-6,
                                    "fetch.tracks": 153e-6})
    assert "fetch.tracks" not in t.kernel_s      # its device copy: no op
    assert t.busy_s == pytest.approx((15 + 22 + 83 + 2 + 10) * 1e-6)

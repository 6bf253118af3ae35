"""The traced part of a window: torch.profiler over a fixed number of
chunks, reduced to what the per-layer readers take.

Device time per layer: the device time of the kernels launched inside the
program's own profiler ranges (record_function in pipeline/runner.py),
plus, by kernel name, the kernels launched through ctypes, which the
profiler places in no range; the readers name those kernels and their
layer (KERNELS, STAGE). Busy time is the union of every device operation's
interval (kernels, copies, sets); the idle gaps between them are put
under the innermost host range open at their midpoint: one of the
program's stages, or the benchmark's own spans around its two calls.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

# The benchmark's own host spans around its two calls into the program.
SPAN_CALL = "bench.process_chunk_device"
SPAN_FETCH = "bench.fetch_chunk_outputs"


@dataclasses.dataclass
class Trace:
    window_s: float                 # host clock over the traced chunks
    busy_s: float                   # union of device operations
    device_total_s: float           # sum of device operation times
    stage_s: dict                   # range name -> device seconds
    kernel_s: dict                  # device operation name -> seconds
    gaps: dict                      # host range -> idle seconds
    frames: int
    chunks: int

    def kernels_matching(self, patterns) -> float:
        return sum(s for name, s in self.kernel_s.items()
                   if any(p in name for p in patterns))

    def layer_s(self, stage: str | None, patterns=()) -> float:
        return (self.stage_s.get(stage, 0.0) if stage else 0.0) \
            + self.kernels_matching(patterns)


@contextlib.contextmanager
def profiling():
    """torch.profiler with CPU and CUDA activity; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, stages, window_s: float, frames: int, chunks: int) -> Trace:
    """The profiler's events -> Trace. stages: the program's range names."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ranges = set(stages) | {SPAN_CALL, SPAN_FETCH}
    stage_s = defaultdict(float)
    kernel_s = defaultdict(float)
    host = []                      # (start_us, end_us, name)
    dev = []
    for e in prof.events():
        if e.name in ranges or getattr(e, "is_user_annotation", False):
            if e.device_type != cuda:
                host.append((e.time_range.start, e.time_range.end, e.name))
                if e.name in stages:
                    stage_s[e.name] += e.device_time_total / 1e6
            continue
        if e.device_type == cuda:
            start, end = e.time_range.start, e.time_range.end
            dev.append((start, end))
            kernel_s[" ".join(e.name.split())] += (end - start) / 1e6
    merged = _merge(dev)
    busy = sum(e - s for s, e in merged) / 1e6
    gaps = defaultdict(float)
    host.sort(key=lambda r: r[1] - r[0])
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        name = next((n for s, e, n in host if s <= mid <= e), "no_stage")
        gaps[name] += (s1 - e0) / 1e6
    return Trace(window_s, busy, sum(kernel_s.values()), dict(stage_s),
                 dict(kernel_s), dict(gaps), frames, chunks)


def breakdown(trace: Trace) -> dict:
    top = sorted(trace.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:96], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


class Probes:
    """Records the first calls of the program functions that readers name
    ("module:attribute"), by wrapping the attribute where its caller looks
    it up, while installed; the arguments are kept as given."""

    def __init__(self, targets, keep: int = 2):
        self.targets = sorted(set(targets))
        self.keep = keep
        self.calls = {t: [] for t in self.targets}
        self.count = dict.fromkeys(self.targets, 0)
        self._saved = []

    def install(self):
        import importlib
        for t in self.targets:
            mod_name, attr = t.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(t, fn))

    def _wrap(self, target, fn):
        def wrapper(*args, **kwargs):
            result = fn(*args, **kwargs)
            self.count[target] += 1
            if len(self.calls[target]) < self.keep:
                self.calls[target].append((args, kwargs, result))
            return result
        return wrapper

    def remove(self):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []

"""What one run measured, as the metric readers take it."""
from __future__ import annotations

import dataclasses

from . import spec


@dataclasses.dataclass
class Context:
    config: dict
    traffic: dict
    setup_s: float
    t_start: float
    chunks: list                  # (t_call, t_enqueued, t_fetched, frames)
    traced: range                 # indices of the profiled chunks
    trace: object = None          # trace.Trace, with --trace 1
    probes: object = None         # trace.Probes, with --trace 1
    peaks: dict | None = None
    root: str = spec.ROOT
    _work: dict = dataclasses.field(default_factory=dict)

    @property
    def frames(self) -> int:
        return sum(c[3] for c in self.chunks)

    @property
    def window_s(self) -> float:
        return self.chunks[-1][2] - self.t_start

    @staticmethod
    def latencies_ms(chunks) -> list:
        return [1e3 * (t2 - t0) for t0, _, t2, _ in chunks]

    def untraced_chunks(self) -> list:
        rest = [c for i, c in enumerate(self.chunks) if i not in self.traced]
        return rest or self.chunks

    def layer_ms_per_frame(self, stage, kernels=()):
        t = self.trace
        if t is None or t.busy_s <= 0:
            return None
        return 1e3 * t.layer_s(stage, kernels) / t.frames

    def work(self, name: str):
        if name not in self._work:
            self._work[name] = spec.load_module("work", name, self.root)
        return self._work[name]

    def probe_calls(self, target: str) -> list:
        return [] if self.probes is None else self.probes.calls[target]

    def probe_count(self, target: str) -> int:
        return 0 if self.probes is None else self.probes.count[target]

"""Two times of a kernel call on the card, by CUDA events.

call_ms: the call as the pipeline makes it. Events around `reps` calls
issued back to back from the host; when the host enqueues a call more
slowly than the device runs it, this is the host's time per call (the
wrapper's checks and allocations, ctypes, the launch), not the kernel's.

device_ms: the same calls with the device kept ahead of the host. A
torch.cuda._sleep long enough to cover the host's enqueue of all `reps`
calls is queued first, then the start event, the calls and the end event;
the device then runs the calls back to back, and the events give its time
per call (each kernel plus the gap between two launches on one stream,
none of the host's). The sleep is checked to have covered the enqueue (the
start event has not completed when the last call is queued) and doubled
until it does. `fn` must not synchronise with the host.

Both need a CUDA card; both warm up with one call first. loop_ms is
call_ms on a CUDA device and the host's clock around the calls on the CPU
(the command line's component times, on either device).
"""
from __future__ import annotations

import time

import torch

# A bound on the SM clock (H100 SXM: 1.98 GHz at most): sleep cycles per
# second of host time.
_CLOCK_HZ = 2.0e9


def call_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` calls issued back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms per call over `reps` calls run back to back by a
    device that the host does not hold back."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    cycles = int(2.0 * host_s * _CLOCK_HZ) + 1_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(8):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
        cycles *= 2
    raise RuntimeError("device_ms: the host's enqueue outran the sleep")


def loop_ms(fn, reps: int, device) -> float:
    """Mean ms per call of `reps` calls issued back to back after one
    warm-up call: call_ms on a CUDA device (events, then a synchronize),
    the host's clock on the CPU."""
    if torch.device(device).type == "cuda":
        return call_ms(fn, reps)
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) / reps * 1e3

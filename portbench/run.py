"""Runs one cell of the benchmark of posebyte_tpu_torch once.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

From the root of a checkout. The cell's configuration, traffic and
metrics come from BENCHMARK.json and the data files under portbench/
(README.md there). Set-up builds the program's pipeline, makes the clip
from the seed and holds it on the card, and runs the warm-up chunks; the
window then drives process_chunk_device and fetch_chunk_outputs, one chunk
in flight, for S seconds; with --trace 1 the profiler covers a fixed
number of its chunks. After the window the outputs of the checked chunks
are held against the plain reference (harness/check.py). The last line
of standard output is the result as one JSON object; the numbers compared
and their limits end standard error.

Exits 2 without a result when there is no CUDA card or fewer than the cell
needs, 3 when the JAX package or JAX is loaded in the process.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "posebyte_tpu")


def set_cache_dirs(root: str = ROOT):
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run builds (the program's nvcc
    library, and any Triton or CUDA JIT cache)."""
    cache = os.path.join(root, "build", "portbench")
    os.environ["POSEBYTE_CUDA_BUILD_DIR"] = os.path.join(cache, "cuda")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def sequence_index(traffic: dict, chunk: int) -> list:
    """Positions in the clip of the frames of window chunk `chunk`: the
    clip forward, then backward, and so on ("pingpong")."""
    n, k = traffic["clip_frames"], traffic["chunk"]
    out = []
    for p in range(chunk * k, (chunk + 1) * k):
        i = p % (2 * n)
        out.append(i if i < n else 2 * n - 1 - i)
    return out


def run_window(pipe, frames, traffic, seconds, keep, trace_range, probes,
               prof_ctx):
    """The closed loop: one chunk in flight, for `seconds`, and at least
    the checked first chunks and the profiled ones. Returns the chunk
    timings, the kept chunks {index: (tracker state before, state after,
    outputs)}, the last chunk's, and the profiler and its host span, when
    traced."""
    from torch.profiler import record_function

    from portbench.harness.trace import SPAN_CALL, SPAN_FETCH
    h, w, k = traffic["height"], traffic["width"], traffic["chunk"]
    period = frames.shape[0]
    least = max(trace_range.stop, traffic["check"]["start_chunks"])
    chunks, kept = [], {}
    prof = prof_span = None
    last = None
    t_start = time.perf_counter()
    c = 0
    while True:
        if c == trace_range.start and prof_ctx is not None:
            prof = prof_ctx.__enter__()
            probes.install()
            t_trace = time.perf_counter()
        t0 = time.perf_counter()
        if t0 - t_start >= seconds and c >= least:
            break
        s = (c * k) % period
        before = pipe.state
        with record_function(SPAN_CALL):
            if traffic["frames_on"] == "device":
                outs = pipe.process_chunk_device(frames[s:s + k], h, w)
            else:
                outs = pipe.process_chunk(frames[s:s + k])
        t1 = time.perf_counter()
        with record_function(SPAN_FETCH):
            res = pipe.fetch_chunk_outputs(outs, w, h)
        t2 = time.perf_counter()
        chunks.append((t0, t1, t2, k))
        if c in keep:
            kept[c] = (before, pipe.state, res)
        last = (c, before, pipe.state, res)
        c += 1
        if prof is not None and c == trace_range.stop:
            prof_span = time.perf_counter() - t_trace
            probes.remove()
            prof_ctx.__exit__(None, None, None)
            prof_ctx = None
    return t_start, chunks, kept, last, prof, prof_span


def main(argv=None, device=None, root=ROOT, program_config=None):
    """One run; returns the result dict (also printed). device=None takes
    the CUDA card and refuses to run without one; tests pass "cpu" and a
    root of their own (a checkout's root: BENCHMARK.json, portbench/ and
    the checkpoints). program_config: the configuration the program is
    built with in place of the cell's (the control of a cell whose program
    has a path of lower precision); the reference keeps the cell's."""
    args = parse(argv)
    set_cache_dirs(root)
    import numpy as np
    import torch

    from portbench.harness import check as CK
    from portbench.harness import program, spec, trace as TR
    from portbench.harness.context import Context
    from portbench.harness.peaks import peaks
    from portbench.reference.scene import render_clip

    cell = spec.load_cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            say(f"{cell.name} needs {cell.chips} CUDA card(s); "
                f"found {torch.cuda.device_count()}")
            raise SystemExit(2)
        device = "cuda"
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg, tr = cell.config, cell.traffic
    torch.manual_seed(args.seed)

    # ---- set-up -----------------------------------------------------------
    marks = [("imports", time.perf_counter())]
    pipe = program.build(program_config or cfg, args.seed, device, root)
    marks.append(("pipeline", time.perf_counter()))
    clip = render_clip(tr["clip_frames"], tr["width"], tr["height"],
                       tr["persons"], args.seed, tuple(tr["scale_range"]),
                       tr["speed"])
    flat = torch.from_numpy(clip.reshape(len(clip), -1))
    if tr["frames_on"] == "device":
        flat = flat.to(dev)
        frames = torch.cat([flat, flat.flip(0)])
    else:
        frames = np.concatenate([clip, clip[::-1]])
    del flat
    marks.append(("clip", time.perf_counter()))
    for c in range(tr["warmup_chunks"]):
        s = (c * tr["chunk"]) % frames.shape[0]
        part = frames[s:s + tr["chunk"]]
        outs = pipe.process_chunk_device(part, tr["height"], tr["width"]) \
            if tr["frames_on"] == "device" else pipe.process_chunk(part)
        pipe.fetch_chunk_outputs(outs, tr["width"], tr["height"])
    pipe.reset()
    outs = None
    marks.append(("warm-up", time.perf_counter()))
    readers = {m["name"]: spec.load_module("metrics", m["name"], root)
               for m in cell.end_to_end + cell.per_layer}
    prof_ctx = probes = None
    trace_range = range(0)
    if args.trace:
        t = tr["trace"]
        trace_range = range(t["skip_chunks"], t["skip_chunks"] + t["chunks"])
        probes = TR.Probes([p for r in readers.values()
                            for p in getattr(r, "PROBES", ())])
        if cuda:
            with TR.profiling():      # the profiler's own first start
                torch.zeros(1, device=dev).add_(1)
            prof_ctx = TR.profiling()
        else:
            trace_range = range(0)
    chk = tr["check"]
    rng = np.random.default_rng([args.seed, 1])
    keep = set(range(chk["start_chunks"])) | set(
        int(x) for x in rng.integers(chk["start_chunks"],
                                     chk["sample_below"],
                                     chk["sampled_chunks"]))
    if cuda:
        torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T0

    # ---- window -----------------------------------------------------------
    t_start, chunks, kept, last, prof, prof_span = run_window(
        pipe, frames, tr, args.seconds, keep, trace_range, probes, prof_ctx)
    gc.unfreeze()
    found = forbidden_modules()
    if cuda:
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    ctx = Context(cfg, tr, setup_s, t_start, chunks, trace_range,
                  peaks=peaks(kind) if cuda else None, root=root)
    result_extra = {}
    if prof is not None:
        stages = {getattr(r, "STAGE", None) for r in readers.values()} - {None}
        frames_traced = len(trace_range) * tr["chunk"]
        ctx.trace = TR.reduce(prof, stages, prof_span, frames_traced,
                              len(trace_range))
        ctx.probes = probes
        result_extra["breakdown"] = TR.breakdown(ctx.trace)
    entries = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in entries:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # ---- the program's state goes; the checked chunks -> the reference -----
    # runs of checked chunks: the window's first ones from a fresh tracker
    # (None), each later one from the program's state before it
    if chk["last_chunk"] and last[0] not in kept:
        kept[last[0]] = last[1:]
    first = sorted(c for c in kept if c < chk["start_chunks"])
    runs = [(first, None)] + [
        ([c], program.tracker_state_numpy(kept[c][0]))
        for c in sorted(kept) if c >= chk["start_chunks"]]
    ends = {c: CK.state_ids(program.tracker_state_numpy(kept[c][1]))
            for c in kept}
    results = {c: kept[c][2] for c in kept}
    ctx.probes = None
    del pipe, frames, kept, last, outs, probes, prof
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    params = CK.M.read_checkpoint(os.path.join(root, cfg["checkpoint"]))
    convs = CK.reference_convs(cfg, params, args.seed, dev, root=root)
    dets = CK.reference_detections(cfg, convs, clip, dev, root=root)
    segments = []
    for cs, state in runs:
        prog, ref, pairs = [], [], []
        for c in cs:
            frames_c, trk = CK.reference_tracks(
                cfg, dets, sequence_index(tr, c), state, tr["width"],
                tr["height"])
            state = trk.s
            ref += frames_c
            prog += results[c]
            pairs.append((ends[c], CK.state_ids(state)))
        segments.append((prog, ref, pairs))
    numbers = CK.compare(segments)
    t_ref = time.perf_counter() - t_ref
    limits = cell.check["limits"]
    correct = CK.verdict(numbers, limits)

    found = sorted(set(found) | set(forbidden_modules()))
    if found:
        say(f"modules of JAX or the JAX package are loaded: {found}")
        raise SystemExit(3)
    say("set-up s: " + ", ".join(
        f"{n} {t - t0}" for (n, t), (_, t0) in zip(marks, [("", T0)] + marks))
        + f"; total {setup_s}")
    lat = ctx.latencies_ms(chunks)
    say(f"window: {len(chunks)} chunks, {ctx.frames} frames in "
        f"{ctx.window_s} s; chunk latency median {float(np.median(lat))} "
        f"ms, p95 {float(np.percentile(lat, 95))} ms")
    if ctx.trace is not None:
        t = ctx.trace
        by_range = {st: t.stage_s.get(st, 0.0) for st in stages}
        by_name = t.kernels_matching({k for r in readers.values()
                                      for k in getattr(r, "KERNELS", ())})
        unattributed = t.device_total_s - sum(by_range.values()) - by_name
        say(f"traced {t.chunks} chunks in {t.window_s} s: device busy "
            f"{t.busy_s} s, operations {t.device_total_s} s; by layer "
            f"(ranges) {by_range}, by kernel name {by_name} s; attributed "
            f"to no layer {unattributed} s")
    say(f"checked {sum(len(g[1]) for g in segments)} frames of chunks "
        f"{[cs for cs, _ in runs]} against the reference in {t_ref} s")
    say("not compared: " + ", ".join(f"{n} {numbers[n]}" for n in CK.NAMES
                                     if n not in limits))
    for n, lim in limits.items():
        say(f"check {n} {numbers[n]} limit {lim}")
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": peak}
    if ctx.trace is not None:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
    result = {"correct": bool(correct), "attempted": ctx.frames,
              "failed": 0, "metrics": metrics, "device": device_info,
              **result_extra,
              "check": {n: {"value": numbers[n], "limit": lim}
                        for n, lim in limits.items()}}
    print(json.dumps(result), flush=True)
    result["numbers"] = numbers          # every number, for control.py
    return result


if __name__ == "__main__":
    main()

"""Source variants of one kernel on the card: build each, report its
spills, check it against the plain version and time it, in turns.

    python -m posebyte_tpu_torch.utils.kernel_variants KERNEL [VARIANT ...]

KERNEL names a source, csrc/KERNEL.cu: conv_int8, auction or nms_keep. A
VARIANT is NAME=PATH, a whole source built in its place (e.g. a parent
commit's), or a JSON file mapping names to lists of [old, new] text
replacements applied to the package's source ({"base": []} builds it as
it is). Without variants conv_int8 runs ABLATION (its design choices
undone one at a time); the package's own source, "this", is always
measured. All variants compile at once, one nvcc each with the package's
flags and headers, into build/variants/KERNEL/NAME/ (with auction.cu,
which holds posebyte_error_string, where KERNEL is another). Then each
becomes in turn the library that the package's wrappers launch, in the
order given and back again (this a b b a this): only the library under
the one wrapper changes. One JSON line per turn: the instantiations that
spill ({kernel: [registers, spill bytes]}) and, per case, "ms"
(utils.timing.call_ms: the call as the pipeline makes it), "device_ms"
(utils.timing.device_ms: the device's time) and "equal" (the outputs
equal the plain version's). Last the card's name and power limit. Compare
variants within one run: they share the card and its power limit. Needs
a CUDA card and nvcc.

Cases (numpy, seed 7):
  conv_int8  B = 128, bf16 in the path's layouts, the int8 path's
             heaviest shapes: the float mode (the path's), the int8 mode
             (its own "ms"/"device_ms" as int8_ms/int8_device_ms) and
             cuDNN's bf16 conv (cudnn_ms); "equal" on the first 8 frames
  auction    stress (synthetic.auction_case: R = 128, C = 64, ties, ~60%
             locked, chip_smoke.py's case), locked (every pair), batch4
             (four stress matrices, B = 4), tall (R = 1030, C = 20, half
             locked), tier (R = 128, C = 64 as the per-frame path's tiers:
             6 active tracks for 6 detections, one round), v1_max64 and
             v1_max20 (the most rows the 1024-thread v1 fitted, 886 at
             C = 64 and 2730 at C = 20); each with its rounds
             (rounds_out); "empty", a kernel that does nothing
             (torch.cuda._sleep(0)) timed the same way, the card's floor;
             and "profiler_ms", torch.profiler's device time of the kernel
             named auction_kernel on the stress case
  nms_keep   synthetic.nms_case at N = 256 (B = 1, the per-frame path;
             B = 128, a chunk's) and N = 1024 (B = 1)
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import assignment as A
from ..ops import conv_int8 as CI
from ..ops import cuda_lib
from ..ops import nms as N
from .synthetic import auction_case, nms_case
from .timing import call_ms, device_ms

SEED = 7
# (k, stride, H, W, C, pixel stride, O): the int8 path's heaviest shapes
SHAPES = ((3, 1, 80, 80, 64, 64, 64), (3, 1, 80, 80, 51, 51, 51),
          (3, 1, 80, 80, 32, 64, 32), (3, 1, 20, 20, 128, 256, 128),
          (3, 1, 40, 40, 64, 128, 64), (3, 2, 80, 80, 64, 64, 128),
          (1, 1, 40, 40, 384, 384, 128), (1, 1, 80, 80, 64, 64, 64),
          (1, 1, 80, 80, 51, 51, 51))
B = 128
ABLATION = {
    # every A tile tap by tap: no whole-row patches
    "tap_only": [["if (in_type != kInInt8 && s.R > 0) {", "if (false) {"]],
    # patches filled through registers, not by cp.async
    "regs_fill": [["const int fill = in_type == kInBf16 && s.vec_in && "
                   "STRIDE == 1\n", "const int fill = false\n"]],
    # the 1x1 convs as patches too
    "patch_1x1": [["static_assert(!PATCH || (KS == 3 && IN != kInInt8), "
                   "\"\");", "static_assert(!PATCH || IN != kInInt8, \"\");"],
                  ["  if constexpr (KS == 3) {\n    // a patch",
                   "  if constexpr (true) {\n    // a patch"]],
    # a patch block's shared memory at 72 KB (3 blocks per SM)
    "patch_72kb": [["constexpr int kPatchSmem = 110 * 1024;",
                    "constexpr int kPatchSmem = 72 * 1024;"]],
    # the division's cost: a multiply in its place (wrong by design: its
    # "equal" is expected false)
    "no_division": [["rintf(__fdiv_rn(raw_at<IN>(raw, e), sx))",
                     "rintf(raw_at<IN>(raw, e) * sx)"]],
}


def _times(fn, reps: int) -> dict:
    return {"ms": call_ms(fn, reps), "device_ms": device_ms(fn, reps)}


def measure_conv_int8(dev) -> dict:
    res = {}
    for k, st, H, W, C, ps, O in SHAPES:
        s_x = torch.tensor(0.04, device=dev)
        full = (torch.randn((B, H, W, ps), device=dev) * 1.6).to(
            torch.bfloat16)
        x = full.permute(0, 3, 1, 2)[:, ps - C:]
        wq = CI.pack_weights(torch.randint(-127, 128, (O, C, k, k),
                                           dtype=torch.int8, device=dev))
        sc = torch.rand(O, device=dev) * 1e-3
        b = torch.randn(O, device=dev)
        xq = CI.quantize_activation(x, s_x)
        equal = all(torch.equal(
            CI.conv_w8a8_cuda(x[:8], s_x, wq, sc, b, k, st, dt),
            CI.conv_w8a8_plain(x[:8], s_x, wq, sc, b, k, st, dt))
            for dt in (torch.int32, torch.bfloat16))
        row = _times(lambda: CI.conv_w8a8_cuda(x, s_x, wq, sc, b, k, st), 20)
        int8 = _times(lambda: CI.conv_int8_cuda(xq, wq, sc, b, k, st), 20)
        xb = full.permute(0, 3, 1, 2)[:, :C].contiguous(
            memory_format=torch.channels_last)
        wb = torch.randn((O, C, k, k), device=dev).to(torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
        res[f"{k}x{k}s{st} {H}x{W} C{C} ps{ps} O{O}"] = {
            **row, "int8_ms": int8["ms"], "int8_device_ms": int8["device_ms"],
            "cudnn_ms": call_ms(lambda: F.conv2d(xb, wb, None, stride=st,
                                                 padding=k // 2), 20),
            "equal": equal}
    return res


def auction_cases() -> dict:
    """{name: (cost [B, R, C] float32, active [B, R] bool)} in numpy."""
    rng = np.random.default_rng(SEED)
    out = {}
    c, a = auction_case(rng)
    out["stress"] = (c[None], a[None])
    out["locked"] = (np.full((1, 128, 64), 1e9, np.float32),
                     np.ones((1, 128), bool))
    four = [auction_case(rng) for _ in range(4)]
    out["batch4"] = (np.stack([f[0] for f in four]),
                     np.stack([f[1] for f in four]))
    for name, R, C in (("tall", 1030, 20), ("v1_max64", 886, 64),
                       ("v1_max20", 2730, 20)):
        c = rng.uniform(0, 1, (R, C)).astype(np.float32)
        c[rng.uniform(size=c.shape) < 0.5] = 1e9
        out[name] = (c[None], (rng.uniform(size=R) >= 0.1)[None])
    c = np.full((128, 64), 1e9, np.float32)
    c[:6, :6] = rng.uniform(0.5, 0.9, (6, 6))
    c[np.arange(6), rng.permutation(6)] = rng.uniform(0.05, 0.2, 6)
    out["tier"] = (c[None], (np.arange(128) < 6)[None])
    return out


def profiler_ms(fn, reps: int, name: str) -> float:
    """torch.profiler's mean device ms per call of the kernels whose name
    holds `name`, over `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total",
                        getattr(e, "cuda_time_total", 0.0))
                for e in prof.key_averages() if name in e.key)
    return total / 1e3 / reps


def measure_auction(dev) -> dict:
    res = {}
    for name, (c_np, a_np) in auction_cases().items():
        c, a = torch.from_numpy(c_np).to(dev), torch.from_numpy(a_np).to(dev)
        rounds = torch.zeros(c.shape[0], dtype=torch.int32, device=dev)
        row, col = A.auction_assign_cuda(c, a, rounds=rounds)
        plain = [A.auction_assign_rounds(c[b], a[b]) for b in range(len(c))]
        res[name] = {
            "shape": list(c.shape), "rounds": rounds.tolist(),
            "equal": all(torch.equal(row[b], p[0]) and torch.equal(col[b],
                                                                   p[1])
                         and int(rounds[b]) == p[2]
                         for b, p in enumerate(plain)),
            **_times(lambda: A.auction_assign_cuda(c, a), 200)}
        if name == "stress":
            res[name]["profiler_ms"] = profiler_ms(
                lambda: A.auction_assign_cuda(c, a), 50, "auction_kernel")
    res["empty"] = {"device_ms": device_ms(lambda: torch.cuda._sleep(0),
                                           200)}
    return res


def measure_nms_keep(dev) -> dict:
    res = {}
    for n, b, n_valid in ((256, 1, 240), (256, 128, 240), (1024, 1, 1000)):
        rng = np.random.default_rng(SEED)
        sets = [nms_case(rng, n=n, n_valid=n_valid, chain=40 * (i % 2 == 0))
                for i in range(b)]
        p, bx, v = (torch.from_numpy(np.stack([s[i] for s in sets])).to(dev)
                    for i in range(3))
        try:
            got = N.nms_keep_cuda(p, bx, v, 0.55, 0.55)
        except RuntimeError as e:     # a variant that refuses this N
            res[f"N={n},B={b}"] = {"error": str(e)}
            continue
        equal = all(torch.equal(got[i], N.nms_keep_plain(p[i], bx[i], v[i],
                                                         0.55, 0.55))
                    for i in range(b))
        res[f"N={n},B={b}"] = {"equal": equal, **_times(
            lambda: N.nms_keep_cuda(p, bx, v, 0.55, 0.55), 200)}
    return res


MEASURE = {"conv_int8": measure_conv_int8, "auction": measure_auction,
           "nms_keep": measure_nms_keep}


def sources(kernel: str, args: list[str]) -> dict:
    """{variant name: its source text} from the command's VARIANTs."""
    with open(os.path.join(cuda_lib.CSRC, kernel + ".cu")) as f:
        src0 = f.read()
    reps = ABLATION if kernel == "conv_int8" and not args else {}
    out = {}
    for arg in args:
        if "=" in arg:
            name, path = arg.split("=", 1)
            with open(path) as f:
                out[name] = f.read()
        else:
            with open(arg) as f:
                reps = {**reps, **json.load(f)}
    for name, pairs in reps.items():
        src = src0
        for old, new in pairs:
            if old not in src:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        out[name] = src
    return out


def build(kernel: str, variants: dict, root: str) -> dict:
    """{name: (library path or None, nvcc's output)}; all built at once."""
    procs = {}
    for name, src in variants.items():
        d = os.path.join(root, kernel, name)
        os.makedirs(d, exist_ok=True)
        for h in cuda_lib.HEADERS:
            shutil.copy(os.path.join(cuda_lib.CSRC, h), d)
        files = [os.path.join(d, kernel + ".cu")]
        with open(files[0], "w") as f:
            f.write(src)
        if kernel != "auction":   # posebyte_error_string lives in auction.cu
            files.append(os.path.join(d, "auction.cu"))
            shutil.copy(os.path.join(cuda_lib.CSRC, "auction.cu"), files[1])
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o",
               os.path.join(d, "lib.so"), *files]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    out = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        out[name] = (os.path.join(d, "lib.so") if proc.returncode == 0
                     else None, log)
    return out


def spills(log: str) -> dict:
    """{mangled kernel: [registers, spill store bytes]} of the spilling
    ones, from nvcc's -Xptxas -v output."""
    res, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            res.setdefault(name, [0, 0])[0] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            res.setdefault(name, [0, 0])[1] = int(m.group(1))
    return {k: v for k, v in res.items() if v[1]}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args or args[0] not in MEASURE or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    kernel, dev = args[0], torch.device("cuda")
    root = os.path.join(os.path.dirname(cuda_lib.build_dir()), "variants")
    libs, logs = {}, {}
    for name, (path, log) in build(kernel, sources(kernel, args[1:]),
                                   root).items():
        if path is None:
            print(json.dumps({"variant": name, "build_failed": log[-3000:]}),
                  flush=True)
        else:
            libs[name], logs[name] = cuda_lib.bind(path), log
    this = cuda_lib.load()
    libs = {"this": this, **libs}
    order = list(libs) + list(libs)[::-1]
    print(torch.cuda.get_device_name(0), flush=True)
    for name in order:
        cuda_lib.use(libs[name])
        spilling = spills(logs[name]) if name in logs else {
            k: [u.get("registers"), u["spill_stores"]]
            for k, u in cuda_lib.ptxas_usage().items()
            if u.get("spill_stores")}
        print(json.dumps({"variant": name, "spilling": spilling,
                          **MEASURE[kernel](dev)}), flush=True)
    cuda_lib.use(this)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Kernel 4 source variants on the card: build each, report its spills,
check it against the plain version and time it at the int8 path's shapes.

    python -m posebyte_tpu_torch.utils.kernel_variants [variants.json]

variants.json maps a name to a list of [old, new] text replacements applied
to csrc/conv_int8.cu ({"base": []} builds the source as it is); without
it, ABLATION: the source against each of its design choices undone. All
variants compile at once, one nvcc each with the package's flags, into
build/variants/<name>/; then each in turn becomes the library that
ops.conv_int8's wrappers launch. Per variant one JSON line: the
instantiations that spill ([registers, spill bytes]) and, per shape at
B = 128 (bf16, the path's layouts), [float mode ms, int8 mode ms, cuDNN
bf16 ms, elements that differ from the plain version on the first 8
frames], and the sums. Compare variants within one run: they share the
card and its power limit. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import conv_int8 as CI
from ..ops import cuda_lib

# (k, stride, H, W, C, pixel stride, O): the int8 path's heaviest shapes
SHAPES = ((3, 1, 80, 80, 64, 64, 64), (3, 1, 80, 80, 51, 51, 51),
          (3, 1, 80, 80, 32, 64, 32), (3, 1, 20, 20, 128, 256, 128),
          (3, 1, 40, 40, 64, 128, 64), (3, 2, 80, 80, 64, 64, 128),
          (1, 1, 40, 40, 384, 384, 128), (1, 1, 80, 80, 64, 64, 64),
          (1, 1, 80, 80, 51, 51, 51))
B = 128
ABLATION = {
    "base": [],
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
    # the division's cost: a multiply in its place (wrong by design; its
    # elements that differ are expected)
    "no_division": [["rintf(__fdiv_rn(raw_at<IN>(raw, e), sx))",
                     "rintf(raw_at<IN>(raw, e) * sx)"]],
}


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _differ(a, b):
    torch.cuda.synchronize()
    return int((a.float().view(torch.int32) != b.float().view(torch.int32))
               .sum()) if a.dtype != torch.int32 else int((a != b).sum())


def build(variants: dict, root: str) -> dict:
    """{name: (library path or None, nvcc's output)}; all built at once."""
    with open(os.path.join(cuda_lib.CSRC, "conv_int8.cu")) as f:
        src0 = f.read()
    procs = {}
    for name, reps in variants.items():
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        src = src0
        for old, new in reps:
            if old not in src:
                raise ValueError(f"variant {name}: {old!r} not in the source")
            src = src.replace(old, new)
        with open(os.path.join(d, "conv_int8.cu"), "w") as f:
            f.write(src)
        # posebyte_error_string lives in auction.cu
        for extra in ("auction.cu", "auction.cuh"):
            with open(os.path.join(cuda_lib.CSRC, extra)) as f, \
                    open(os.path.join(d, extra), "w") as g:
                g.write(f.read())
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o",
               os.path.join(d, "lib.so"), os.path.join(d, "conv_int8.cu"),
               os.path.join(d, "auction.cu")]
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


def measure(lib_path: str) -> dict:
    """Load the variant as the wrappers' library and time SHAPES."""
    lib = ctypes.CDLL(lib_path)
    for f in ("posebyte_conv_int8", "posebyte_error_string"):
        getattr(lib, f).restype, getattr(lib, f).argtypes = \
            cuda_lib._SIGNATURES[f]
    cuda_lib._lib = lib
    dev = torch.device("cuda")
    res, tot = {}, [0.0, 0.0, 0.0]
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
        n = sum(_differ(CI.conv_w8a8_cuda(x[:8], s_x, wq, sc, b, k, st, dt),
                        CI.conv_w8a8_plain(x[:8], s_x, wq, sc, b, k, st, dt))
                for dt in (torch.int32, torch.bfloat16))
        times = [_ms(lambda: CI.conv_w8a8_cuda(x, s_x, wq, sc, b, k, st)),
                 _ms(lambda: CI.conv_int8_cuda(xq, wq, sc, b, k, st))]
        xb = full.permute(0, 3, 1, 2)[:, :C].contiguous(
            memory_format=torch.channels_last)
        wb = torch.randn((O, C, k, k), device=dev).to(torch.bfloat16) \
            .contiguous(memory_format=torch.channels_last)
        times.append(_ms(lambda: F.conv2d(xb, wb, None, stride=st,
                                          padding=k // 2)))
        res[f"{k}x{k}s{st} {H}x{W} C{C} ps{ps} O{O}"] = times + [n]
        tot = [a + t for a, t in zip(tot, times)]
    res["total"] = tot
    return res


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) > 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    variants = ABLATION
    if args:
        with open(args[0]) as f:
            variants = json.load(f)
    root = os.path.join(os.path.dirname(cuda_lib.build_dir()), "variants")
    print(torch.cuda.get_device_name(0), flush=True)
    for name, (path, log) in build(variants, root).items():
        if path is None:
            print(json.dumps({"variant": name, "build_failed": log[-3000:]}),
                  flush=True)
            continue
        print(json.dumps({"variant": name, "spilling": spills(log),
                          **measure(path)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

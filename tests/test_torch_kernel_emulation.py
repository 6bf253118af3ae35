"""The CUDA kernel sources (posebyte_tpu_torch/csrc/*.cu), compiled for the
CPU with csrc/emulation/cuda_on_cpu.h (one thread per CUDA thread, a
barrier per block), against their plain PyTorch versions.

This holds the kernels' logic -- thread mapping, shared-memory layout,
barriers and uniform loop exits, tie rules -- on a host without a card.
Each emulated launch runs in a child process with a time limit, so a
barrier that not every thread reaches fails the test instead of hanging
it. Tolerance: none (keep masks and assignments equal). Needs g++ with
C++20; the card itself is tested in tests/test_torch_cuda.py.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from posebyte_tpu_torch.ops import assignment as A
from posebyte_tpu_torch.ops import cuda_lib
from posebyte_tpu_torch.ops import nms as N
from posebyte_tpu_torch.utils.synthetic import POSE_OFFSETS

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Runs one emulated launch: argv = library, kind, inputs.npz, outputs.npz.
DRIVER = r"""
import ctypes, sys
import numpy as np
from posebyte_tpu_torch.ops import cuda_lib
lib = ctypes.CDLL(sys.argv[1])
for name, (restype, argtypes) in cuda_lib._SIGNATURES.items():
    getattr(lib, name).restype = restype
    getattr(lib, name).argtypes = argtypes
d = dict(np.load(sys.argv[3]))
if sys.argv[2] == "nms":
    B, n = d["valid"].shape
    keep = np.zeros((B, n), np.uint8)
    st = lib.posebyte_nms_keep(d["poses"].ctypes.data, d["boxes"].ctypes.data,
                               d["valid"].ctypes.data, keep.ctypes.data, B, n,
                               float(d["iou"]), float(d["oks"]),
                               d["sig4"].ctypes.data, None)
    np.savez(sys.argv[4], status=st, keep=keep)
else:
    B, R, C = d["cost"].shape
    row = np.zeros((B, R), np.int32)
    col = np.zeros((B, C), np.int32)
    st = lib.posebyte_auction(d["cost"].ctypes.data, d["active"].ctypes.data,
                              row.ctypes.data, col.ctypes.data, B, R, C,
                              int(d["iters"]), float(d["eps0"]), None)
    np.savez(sys.argv[4], status=st, row=row, col=col)
"""


def _to_cpp(src: str) -> str:
    src = src.replace("#include <cuda_runtime.h>",
                      '#include "emulation/cuda_on_cpu.h"')
    src = re.sub(r"extern __shared__ ([\w ]+?) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(g_smem);", src)
    return re.sub(
        r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),\s*.*?>>>\(([^;]*)\);",
        lambda m: (f"emu_launch({m.group(2)}, {m.group(3)}, {m.group(4)}, "
                   f"[&]() {{ {m.group(1)}({m.group(5)}); }});"),
        src, flags=re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for the CPU")
    out = tmp_path_factory.mktemp("emu")
    shutil.copytree(os.path.join(cuda_lib.CSRC, "emulation"),
                    out / "emulation")
    for name in cuda_lib.HEADERS:
        with open(os.path.join(cuda_lib.CSRC, name)) as f:
            (out / name).write_text(_to_cpp(f.read()))
    cpps = []
    for name in cuda_lib.SOURCES:
        with open(os.path.join(cuda_lib.CSRC, name)) as f:
            cpp = out / (name[:-3] + ".cpp")
            cpp.write_text(_to_cpp(f.read()))
            cpps.append(str(cpp))
    lib = out / "libemulated.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared",
                        "-pthread", "-ffp-contract=off", "-I", str(out),
                        "-o", str(lib), *cpps],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return str(lib), out


def _launch(emulated, kind, **inputs):
    lib, out = emulated
    src, dst = out / f"{kind}_in.npz", out / f"{kind}_out.npz"
    np.savez(src, **inputs)
    r = subprocess.run([sys.executable, "-c", DRIVER, lib, kind, str(src),
                        str(dst)], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr[-3000:]
    res = dict(np.load(dst))
    assert int(res.pop("status")) == 0
    return res


def candidates(seed, n, n_valid, chain=0):
    rng = np.random.default_rng(seed)
    n_cl = max(1, n // 12)
    centers = rng.uniform(60, 580, (n_cl, 2))
    scales = rng.uniform(40, 160, n_cl)
    cl = rng.integers(0, n_cl, n)
    poses = np.zeros((n, 17, 3), np.float32)
    poses[..., :2] = (centers[cl][:, None] + POSE_OFFSETS[None]
                      * scales[cl][:, None, None]
                      + rng.normal(0, 4, (n, 17, 2)))
    poses[..., 2] = rng.uniform(0, 1, (n, 17))
    for i in range(chain):
        poses[i, :, :2] = 320 + POSE_OFFSETS * 100 + np.float32(i * 9.0) \
            * np.array([1, 0], np.float32)
        poses[i, :, 2] = 0.9
    boxes = np.stack([poses[..., 0].min(1), poses[..., 1].min(1),
                      poses[..., 0].max(1), poses[..., 1].max(1)],
                     -1).astype(np.float32)
    return poses, boxes, np.arange(n) < n_valid


@pytest.mark.parametrize("cases,thr", [
    ([(0, 256, 240, 0)], (0.55, 0.55)),
    ([(1, 256, 256, 40)], (0.55, 0.55)),           # chain deeper than 24
    ([(2, 100, 80, 30), (3, 100, 100, 0), (4, 100, 0, 0)], (0.5, 0.6)),
    ([(5, 512, 500, 0)], (0.65, 0.45)),
    ([(6, 1, 1, 0)], (0.55, 0.55)),
])
def test_nms_kernel_source_matches_plain(emulated, cases, thr):
    sets = [candidates(*c) for c in cases]
    poses, boxes, valid = (np.stack([s[i] for s in sets]) for i in range(3))
    got = _launch(emulated, "nms", poses=poses, boxes=boxes,
                  valid=valid.astype(np.uint8), iou=thr[0], oks=thr[1],
                  sig4=N._SIG4)["keep"].astype(bool)
    for b, (p, bx, v) in enumerate(sets):
        want = N.nms_keep_plain(torch.from_numpy(p), torch.from_numpy(bx),
                                torch.from_numpy(v), *thr).numpy()
        np.testing.assert_array_equal(got[b], want)


def cost_matrix(seed, R, C, locked, ties):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 1, (R, C))
    if ties:
        cost = np.round(cost * 4) / 4
    cost[rng.uniform(size=(R, C)) < locked] = 1e9
    cost[min(3, R - 1), :] = 1e9
    return cost.astype(np.float32), rng.uniform(size=R) >= 0.1


@pytest.mark.parametrize("cases", [
    [(0, 16, 12, 0.0, False)],                     # the whole round budget
    [(1, 128, 64, 0.6, True), (2, 128, 64, 0.7, False),
     (3, 128, 64, 0.9, True)],                     # tracker shape, batched
    [(4, 7, 30, 0.2, True)],
    [(5, 1030, 20, 0.5, False)],                   # more rows than threads
    [(6, 1, 1, 0.0, False)],
])
def test_auction_kernel_source_matches_plain(emulated, cases):
    mats = [cost_matrix(*c) for c in cases]
    R = mats[0][0].shape[0]
    got = _launch(emulated, "auction", cost=np.stack([m[0] for m in mats]),
                  active=np.stack([m[1] for m in mats]).astype(np.uint8),
                  iters=A.auction_iterations(R),
                  eps0=np.float32(1.0 / (R + 1)))
    for b, (cost, active) in enumerate(mats):
        row, col = A.auction_assign(torch.from_numpy(cost),
                                    torch.from_numpy(active))
        np.testing.assert_array_equal(got["row"][b], row.numpy())
        np.testing.assert_array_equal(got["col"][b], col.numpy())

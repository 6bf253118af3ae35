"""The CUDA kernel sources (posebyte_tpu_torch/csrc/*.cu), compiled for the
CPU with csrc/emulation/cuda_on_cpu.h (one thread per CUDA thread, a
barrier per block), against their plain PyTorch versions.

This holds the kernels' logic -- thread mapping, shared-memory layout,
barriers and uniform loop exits, tie rules -- on a host without a card.
Each emulated launch runs in a child process with a time limit, so a
barrier that not every thread reaches fails the test instead of hanging
it. Tolerance: none for keep masks, assignments, the tracker's integers
and Kernel 4's convolution in both modes (int32 sums, bf16 and float32
outputs); tracker floats within 1e-4 px (see assert_tracker_equal), except
the kalman136 filter's mean and covariance, which must be equal (their
arithmetic holds no expf). Needs g++ with C++20; the card itself is tested
in tests/test_torch_cuda.py.
"""
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from posebyte_tpu_torch.ops import assignment as A
from posebyte_tpu_torch.ops import conv_int8 as CI
from posebyte_tpu_torch.ops import cuda_lib
from posebyte_tpu_torch.core.config import TrackerConfig
from posebyte_tpu_torch.core.structs import Detections, TrackerState
from posebyte_tpu_torch.ops import nms as N
from posebyte_tpu_torch.ops import tracker_chunk as TC
from posebyte_tpu_torch.utils.synthetic import POSE_OFFSETS, \
    reid_embeddings_case, tracker_chunk_case

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Runs one emulated launch: argv = library, kind, inputs.npz, outputs.npz.
DRIVER = r"""
import ctypes, sys
import numpy as np
from posebyte_tpu_torch.ops import cuda_lib
lib = ctypes.CDLL(sys.argv[1])


def fn(name):
    f = getattr(lib, name)
    f.restype, f.argtypes = cuda_lib._SIGNATURES[name]
    return f


d = dict(np.load(sys.argv[3]))
if sys.argv[2] == "nms":
    B, n = d["valid"].shape
    keep = np.zeros((B, n), np.uint8)
    mask = np.full((B, n, (n + 31) // 32), 0xA5A5A5A5, np.uint32)
    st = fn("posebyte_nms_keep")(
        d["poses"].ctypes.data, d["boxes"].ctypes.data,
        d["valid"].ctypes.data, mask.ctypes.data, keep.ctypes.data, B, n,
        float(d["iou"]), float(d["oks"]), d["sig4"].ctypes.data, None)
    np.savez(sys.argv[4], status=st, keep=keep)
elif sys.argv[2] == "conv":
    # one launch per row (in_type, k, stride, out_type, tile_m) of cfg, on
    # the same inputs: in_type 0 reads x (int8 [B, H, W, Cp]), 1 and 2 xb
    # (bf16 bits) and xf (float32), [B, H, W, ps], channels x_off .. + C
    B, H, W = d["x"].shape[:3]
    O = d["scale"].shape[0]
    outs = {}
    for i, (in_type, k, stride, out_type, tile) in enumerate(
            d["cfg"].tolist()):
        x, C, off = d["x"], d["x"].shape[3], 0
        if in_type:
            x, C, off = d[("xb", "xf")[in_type - 1]], int(d["C"]), \
                int(d["x_off"])
        w = d[f"w{k}"]
        Ho, Wo = ((n + 2 * (k // 2) - k) // stride + 1 for n in (H, W))
        out = np.zeros((B, Ho, Wo, O),
                       (np.uint16, np.float32, np.int32)[out_type])
        st = fn("posebyte_conv_int8")(
            x.ctypes.data + off * x.itemsize, in_type, d["s_x"].ctypes.data,
            x.shape[3], C, w.ctypes.data, d["scale"].ctypes.data,
            d["bias"].ctypes.data if "bias" in d else None, out.ctypes.data,
            B, H, W, w.shape[2], O, w.shape[0], k, stride, out_type, tile,
            None)
        assert st == 0, st
        outs[f"out{i}"] = out
    np.savez(sys.argv[4], status=0, **outs)
elif sys.argv[2] == "auction":
    B, R, C = d["cost"].shape
    # "active" absent: a null pointer (every row active); "rounds" given:
    # the rounds_out array, returned
    row = np.zeros((B, R), np.int32)
    col = np.zeros((B, C), np.int32)
    act, rounds = d.get("active"), d.get("rounds")
    st = fn("posebyte_auction")(
        d["cost"].ctypes.data, None if act is None else act.ctypes.data,
        row.ctypes.data, col.ctypes.data, B, R, C, int(d["iters"]),
        float(d["eps0"]), None if rounds is None else rounds.ctypes.data,
        None)
    extra = {} if rounds is None else {"rounds": rounds}
    np.savez(sys.argv[4], status=st, row=row, col=col, **extra)
else:
    # inputs in0..in16 in the pointer table's order; in4 (the detections'
    # embeddings) is absent without Re-ID and passed as a null pointer;
    # with kalman136 the filter (kf_mean, kf_cov) and NaN-filled outputs
    # and scratch follow, else five null pointers; last the stage clock
    # (clock, [S, CLOCK_COLUMNS] int64, returned as "clock") or null
    ins = [d.get(f"in{i}") for i in range(17)]
    S, K, D = ins[1].shape
    outs = [np.zeros_like(a) for a in ins[5:]] + [
        np.zeros((S, K, D), np.int32), np.zeros((S, K, D), np.float32),
        np.zeros((S, K, D, 17, 3), np.float32),
        np.zeros((S, K, D, 4), np.float32), np.zeros((S, K, D), np.uint8),
        np.zeros((S, K), np.int32)]
    kf = [None] * 5
    if "kf_mean" in d:
        m = d["kf_mean"]
        kf = [m, d["kf_cov"], np.full_like(m, np.nan), np.full_like(m, np.nan),
              np.full((S, 2) + m.shape[1:], np.nan, np.float32)]
        outs += kf[2:4]
    table = ins + outs[:18] + kf + [d.get("clock")]
    ptrs = (ctypes.c_void_p * len(table))(
        *(None if a is None else a.ctypes.data for a in table))
    st = fn("posebyte_tracker_chunk")(ptrs, d["iargs"].ctypes.data,
                                      d["fargs"].ctypes.data, None)
    extra = {"clock": d["clock"]} if "clock" in d else {}
    np.savez(sys.argv[4], status=st, **extra, **{f"out{i}": a
                                                 for i, a in enumerate(outs)})
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
    ([(7, 512, 500, 40), (8, 512, 512, 30)], (0.55, 0.55)),  # N = 512, B > 1
    ([(9, 1024, 600, 40)], (0.55, 0.55)),          # 128 KB of mask in shared
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


def test_nms_kernel_device_memory_route_matches_plain(emulated, tmp_path):
    """Kernel 1 built with a 4 KB shared-memory budget, so that its greedy
    pass reads the mask from device memory (the route the card takes above
    N = 1350) already at N = 256, against the plain version."""
    lib = _mutant(emulated, tmp_path, "constexpr size_t kMaxSmem = 232448;",
                  "constexpr size_t kMaxSmem = 4096;", source="nms_keep.cu")
    sets = [candidates(1, 256, 256, 40), candidates(2, 256, 200, 30)]
    poses, boxes, valid = (np.stack([s[i] for s in sets]) for i in range(3))
    got = _launch(lib, "nms", poses=poses, boxes=boxes,
                  valid=valid.astype(np.uint8), iou=0.55, oks=0.55,
                  sig4=N._SIG4)["keep"].astype(bool)
    for b, (p, bx, v) in enumerate(sets):
        want = N.nms_keep_plain(torch.from_numpy(p), torch.from_numpy(bx),
                                torch.from_numpy(v), 0.55, 0.55).numpy()
        np.testing.assert_array_equal(got[b], want)


def test_nms_kernel_mutation_is_caught(emulated, tmp_path):
    """A greedy pass that ignores the suppressed bit (every valid rank
    kept and suppressing) must disagree with the plain version on a
    suppression chain."""
    mutant = _mutant(emulated, tmp_path, "if ((live & ~s) >> r & 1u) {",
                     "if (live >> r & 1u) {", source="nms_keep.cu")
    poses, boxes, valid = candidates(1, 256, 256, 40)
    got = _launch(mutant, "nms", poses=poses[None], boxes=boxes[None],
                  valid=valid[None].astype(np.uint8), iou=0.55, oks=0.55,
                  sig4=N._SIG4)["keep"].astype(bool)
    want = N.nms_keep_plain(torch.from_numpy(poses), torch.from_numpy(boxes),
                            torch.from_numpy(valid), 0.55, 0.55).numpy()
    assert not np.array_equal(got[0], want)


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
    # the most rows v1's shared memory took at C = 64 and at C = 20
    [(14, 886, 64, 0.6, True)],
    [(15, 2730, 20, 0.5, False)],
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


def v1_smem_bytes(R, C):
    """Shared memory of the 1024-thread v1 of Kernel 2: the matrix and an
    active byte a row (4 C + 5 bytes), a 64-bit key, a price and an owner a
    column (16 bytes)."""
    return R * (4 * C + 5) + 16 * C


def test_auction_smem_fits_every_shape_v1_took(emulated):
    """For every R, Kernel 2 fits the most columns v1's layout fitted in a
    block's shared memory (posebyte_auction_smem_bytes, the layout the
    launch uses); the largest-R cases of the emulation and card tests sit
    at v1's limit."""
    lib = ctypes.CDLL(emulated[0])
    smem = lib.posebyte_auction_smem_bytes
    smem.restype, smem.argtypes = \
        cuda_lib._SIGNATURES["posebyte_auction_smem_bytes"]
    R = 1
    while (C := (A._MAX_SMEM - 5 * R) // (4 * R + 16)) >= 1:
        assert v1_smem_bytes(R, C) <= A._MAX_SMEM
        assert smem(R, C) <= A._MAX_SMEM, (R, C)
        R += 1
    assert R - 1 == 25825             # v1 took no more rows, at C = 1
    for R, C in ((886, 64), (2730, 20)):
        assert v1_smem_bytes(R, C) <= A._MAX_SMEM < v1_smem_bytes(R + 1, C)
        assert smem(R, C) <= A._MAX_SMEM
    assert smem(512, 512) > A._MAX_SMEM  # the wrappers' refusal case


def _auction_inputs(mats, active=True):
    R = mats[0][0].shape[0]
    d = dict(cost=np.stack([m[0] for m in mats]),
             iters=A.auction_iterations(R), eps0=np.float32(1.0 / (R + 1)))
    if active:
        d["active"] = np.stack([m[1] for m in mats]).astype(np.uint8)
    return d


@pytest.mark.parametrize("cases", [
    [(1, 128, 64, 0.6, True), (3, 128, 64, 0.9, True)],
    [(0, 16, 12, 0.0, False)],                     # the budget runs out
])
def test_auction_kernel_rounds_leave_outputs_unchanged(emulated, cases):
    """rounds_out set: row and col as without it, and each matrix's count
    of rounds with a bid equal to the plain version's."""
    mats = [cost_matrix(*c) for c in cases]
    inputs = _auction_inputs(mats)
    plain = _launch(emulated, "auction", **inputs)
    got = _launch(emulated, "auction", **inputs,
                  rounds=np.full(len(mats), -1, np.int32))
    np.testing.assert_array_equal(got["row"], plain["row"])
    np.testing.assert_array_equal(got["col"], plain["col"])
    want = [A.auction_assign_rounds(torch.from_numpy(c),
                                    torch.from_numpy(a))[2] for c, a in mats]
    np.testing.assert_array_equal(got["rounds"], want)
    assert max(want) > 1


def test_auction_kernel_null_active_is_every_row(emulated):
    """A null active pointer (the wrapper's row_active=None) runs every
    row, as an all-ones mask does."""
    mats = [cost_matrix(s, 128, 64, 0.6, True) for s in (1, 2)]
    got = _launch(emulated, "auction", **_auction_inputs(mats, False))
    for b, (cost, _) in enumerate(mats):
        row, col = A.auction_assign(torch.from_numpy(cost))
        np.testing.assert_array_equal(got["row"][b], row.numpy())
        np.testing.assert_array_equal(got["col"][b], col.numpy())


def edge_matrices(name):
    """[(cost, active)] of an edge case of Kernel 2 v2's bidder set, lane
    groups and tie rules."""
    rng = np.random.default_rng(len(name))
    if name == "all_locked":
        return [(np.full((128, 64), 1e9, np.float32), np.ones(128, bool))]
    if name == "all_inactive":
        return [(rng.uniform(0, 1, (128, 64)).astype(np.float32),
                 np.zeros(128, bool))]
    if name == "one_locked":             # R = 1, C = 1, the pair locked
        return [(np.full((1, 1), 1e9, np.float32), np.ones(1, bool))]
    if name == "ragged":                 # C = 65: 8 lanes, ragged columns
        return [cost_matrix(11, 128, 65, 0.5, True)]
    if name == "ties":                   # every value equal
        return [(np.zeros((128, 64), np.float32), np.ones(128, bool))]
    if name == "budget":                 # 128 rows for 64 columns
        return [cost_matrix(12, 128, 64, 0.0, False)]
    return [cost_matrix(13 + i, 40, 24, 0.4, True)    # B = 3
            for i in range(3)]


# edge cases that share a launch (the two with 50 rounds each launch
# alone, to stay well inside _launch's time limit on a loaded host)
EDGE_LAUNCHES = {"all_locked": "none bid", "all_inactive": "none bid",
                 "ties": "ties", "budget": "budget", "one_locked": "1x1",
                 "ragged": "128x65", "batch3": "40x24"}


@pytest.fixture(scope="module")
def edge_results(emulated):
    """{edge case: (its matrices, the kernel's row, col and rounds)}."""
    out = {}
    for shape in sorted(set(EDGE_LAUNCHES.values())):
        names = [n for n, s in EDGE_LAUNCHES.items() if s == shape]
        mats = [m for n in names for m in edge_matrices(n)]
        got = _launch(emulated, "auction", **_auction_inputs(mats),
                      rounds=np.full(len(mats), -1, np.int32))
        b = 0
        for n in names:
            k = len(edge_matrices(n))
            out[n] = (mats[b:b + k], {key: got[key][b:b + k]
                                      for key in ("row", "col", "rounds")})
            b += k
    return out


@pytest.mark.parametrize("name", list(EDGE_LAUNCHES))
def test_auction_kernel_edge_cases_match_plain(edge_results, name):
    """Kernel 2 on its edge cases: assignments and rounds equal to the
    plain version's."""
    mats, got = edge_results[name]
    for b, (cost, active) in enumerate(mats):
        row, col, rounds = A.auction_assign_rounds(torch.from_numpy(cost),
                                                   torch.from_numpy(active))
        np.testing.assert_array_equal(got["row"][b], row.numpy())
        np.testing.assert_array_equal(got["col"][b], col.numpy())
        assert got["rounds"][b] == rounds
    if name == "budget":
        assert got["rounds"][0] == A.auction_iterations(128)
    if name in ("all_locked", "all_inactive", "one_locked"):
        assert (got["rounds"] == 0).all() and (got["row"] == -1).all()


@pytest.mark.parametrize("old,new", [
    # ties in the lanes' merge sent toward the higher column
    ("(ob == best && oc < best_c)", "(ob == best && oc > best_c)"),
    # the key's row word not inverted: equal top bids to the higher row
    ("unsigned row_key(unsigned r) { return 0xffffffffu - r; }",
     "unsigned row_key(unsigned r) { return r; }"),
    # an evicted row left out of the bidders, though it may bid again
    ("if (old >= 0) atomicOr(&bidders[old >> 5], 1u << (old & 31));", ""),
])
def test_auction_kernel_v2_mutation_is_caught(emulated, tmp_path, old,
                                              new):
    """Kernel 2 with a broken tie rule or bidder set must disagree with
    the plain version on tracker-shaped costs with exact ties."""
    mutant = _mutant(emulated, tmp_path, old, new, source="auction.cu")
    mats = [cost_matrix(s, 128, 64, 0.6, True) for s in (1, 3)] + \
        edge_matrices("ties")
    got = _launch(mutant, "auction", **_auction_inputs(mats))
    rows = [A.auction_assign(torch.from_numpy(c), torch.from_numpy(a))[0]
            .numpy() for c, a in mats]
    assert not np.array_equal(got["row"], np.stack(rows))


@pytest.mark.parametrize("ranked", ["true", "false"])
def test_auction_kernel_both_routes_match_plain(emulated, tmp_path, ranked):
    """Kernel 2 with its bidders always taken by rank ("true") or always
    row by row ("false"), in place of the choice it makes each round,
    equals the plain version: the route changes no bid."""
    lib = _mutant(emulated, tmp_path, "if (2 * n < R) {",
                  f"if ({ranked}) {{", source="auction.cu")
    for mats in ([cost_matrix(s, 128, 64, 0.6, True) for s in (1, 3)] +
                 edge_matrices("ties"), [cost_matrix(5, 1030, 20, 0.5,
                                                     False)]):
        got = _launch(lib, "auction", **_auction_inputs(mats),
                      rounds=np.full(len(mats), -1, np.int32))
        for b, (cost, active) in enumerate(mats):
            row, col, rounds = A.auction_assign_rounds(
                torch.from_numpy(cost), torch.from_numpy(active))
            np.testing.assert_array_equal(got["row"][b], row.numpy())
            np.testing.assert_array_equal(got["col"][b], col.numpy())
            assert got["rounds"][b] == rounds


def tie_case():
    """tracker_case(1, 12, 32, 16, 12) with every frame's first detection
    repeated exactly (pose, box and score) in the slot after it, so that
    the tiers' costs tie between the two columns."""
    state, dets, advance = tracker_case(1, 12, 32, 16, 12)
    arrays = [a.clone() for a in (dets.poses, dets.boxes, dets.scores,
                                  dets.valid)]
    for k in range(arrays[0].shape[0]):
        n = int(dets.valid[k].sum())
        if 0 < n < dets.valid.shape[1]:
            for new, old in zip(arrays, (dets.poses, dets.boxes,
                                         dets.scores, dets.valid)):
                new[k, 1:n + 1] = old[k, :n]
    return state, Detections(*arrays), advance


def test_auction_kernel_mutation_is_caught(emulated, tmp_path):
    """auction_rounds (auction.cuh, Kernel 3's auction since Kernel 2 has
    its own) with its lanes' merge breaking ties toward the higher column
    must make Kernel 3 disagree with the plain version on frames whose
    costs tie; the header as it is agrees."""
    mutant = _mutant(emulated, tmp_path, "(ob == best && oc < best_c)",
                     "(ob == best && oc > best_c)", source="auction.cuh",
                     unit="tracker_chunk.cu")
    state, dets, advance = tie_case()
    cfg = TrackerConfig(max_tracks=32, max_detections=16)
    want_state, want_outs = TC.tracker_chunk_plain(state, dets, cfg, advance)
    inputs = tracker_inputs(state, dets, cfg, advance)
    assert_tracker_equal(_launch(emulated, "tracker", **inputs), want_state,
                         want_outs)
    with pytest.raises(AssertionError):   # a mismatch, or a crash
        got = _launch(mutant, "tracker", **inputs)
        assert_tracker_equal(got, want_state, want_outs)


def tracker_inputs(state, dets, cfg, advance, embs=None):
    """The kernel's input arrays (stream axis S = 1), in the order of the
    wrapper's pointer table (ops/tracker_chunk.py::tracker_chunk_cuda);
    without Re-ID the detections' embeddings (in4) are left out; with
    kalman136 the state's filter is added (kf_mean, kf_cov)."""
    kalman = cfg.motion_model == "kalman136"
    K, D = dets.scores.shape
    T = state.poses.shape[0]
    arrs = [dets.poses, dets.scores, dets.valid, advance, embs] + \
        [getattr(state, n) for n, _ in TC._CARRIED] + \
        [torch.stack([state.next_id, state.frame]), state.det_track_slot]
    arrs = {f"in{i}": a.numpy()[None] for i, a in enumerate(arrs)
            if a is not None}
    arrs = {k: np.ascontiguousarray(a.astype(np.uint8) if a.dtype == bool
                                    else a) for k, a in arrs.items()}
    iargs = np.asarray([1, K, T, D, cfg.min_hits, cfg.max_age,
                        cfg.max_age + cfg.lost_window,
                        A.auction_iterations(T), 2, int(embs is not None),
                        int(kalman)], np.int32)
    if kalman:
        arrs.update(kf_mean=state.kf_mean.numpy()[None],
                    kf_cov=state.kf_cov.numpy()[None])
    return {**arrs, "iargs": iargs, "fargs": TC._float_args(cfg, T)}


def tracker_case(seed, K, T, D, crowd):
    arrays, advance = tracker_chunk_case(seed, K, D, crowd=crowd)
    dets = Detections(*(torch.from_numpy(a) for a in arrays))
    return TrackerState.init(T, D), dets, torch.from_numpy(advance)


def assert_tracker_equal(got, state, outs):
    """Kernel outputs (the child process's out0..out17, and with kalman136
    out18, out19: the filter) against the plain version's state and
    outputs: integers and the filter equal, other floats within 1e-4 px
    (the emulation takes expf from the host's libm, the plain version
    from PyTorch's CPU kernels)."""
    names = [n for n, _ in TC._CARRIED] + ["counters", "det_track_slot"] + \
        list(TC.OUT_KEYS) + ["kf_mean", "kf_cov"]
    want = [getattr(state, n) for n, _ in TC._CARRIED] + \
        [torch.stack([state.next_id, state.frame]), state.det_track_slot] + \
        [outs[k] for k in TC.OUT_KEYS] + [state.kf_mean, state.kf_cov]
    assert ("out18" in got) == (len(got) == 20)
    for i, (name, w) in enumerate(zip(names, want[:len(got)])):
        g, w = got[f"out{i}"][0], w.numpy()
        if name.startswith("kf_"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=name)


@pytest.mark.parametrize("seed,K,T,D,crowd", [
    (1, 12, 32, 16, 12),        # advance holes, crowded frames
    (0, 12, 16, 16, 12),        # slot exhaustion
    (1, 5, 128, 64, 40),        # the main path's pool, crowded frames
    (2, 10, 24, 12, 10),        # D not a multiple of 16: loads, no cp.async
])
def test_tracker_kernel_source_matches_plain(emulated, seed, K, T, D,
                                             crowd):
    state, dets, advance = tracker_case(seed, K, T, D, crowd)
    cfg = TrackerConfig(max_tracks=T, max_detections=D)
    want_state, want_outs = TC.tracker_chunk_plain(state, dets, cfg, advance)
    got = _launch(emulated, "tracker",
                  **tracker_inputs(state, dets, cfg, advance))
    assert_tracker_equal(got, want_state, want_outs)
    assert not advance.all() and want_outs["emit"].any()
    if T == 16:
        assert int(want_outs["num_active"].max()) == T   # the pool is full


@pytest.mark.parametrize("reid", [False, True])
def test_tracker_kernel_empty_and_full_frames(emulated, reid):
    """Kernel 3 (cv, with and without Re-ID) on frames with no valid
    detection and a frame with all D valid (the padding detections then
    count as detections: zero poses, zero scores), against the plain
    version."""
    state, dets, advance = tracker_case(3, 10, 32, 16, 12)
    valid = dets.valid.clone()
    valid[2:4] = False
    valid[6] = True
    dets = dataclasses.replace(dets, valid=valid)
    embs = torch.from_numpy(reid_embeddings_case(3, valid.numpy())) \
        if reid else None
    cfg = TrackerConfig(max_tracks=32, max_detections=16,
                        reid_weight=0.3 if reid else 0.0)
    want_state, want_outs = TC.tracker_chunk_plain(state, dets, cfg, advance,
                                                   embs)
    got = _launch(emulated, "tracker",
                  **tracker_inputs(state, dets, cfg, advance, embs))
    assert_tracker_equal(got, want_state, want_outs)
    assert advance[2:4].all() and advance[6]
    assert want_outs["num_active"][2:4].min() > 0     # tracks that age


def test_tracker_kernel_stage_clock_leaves_outputs_unchanged(emulated):
    """Kernel 3 with its stage clock on (kalman136, Re-ID, advance holes)
    gives the outputs of a run without it, and counts every stage and the
    tier-1 rounds of each stream."""
    state, dets, advance, embs, cfg = kalman_case(2, 12, 32, 16, 12, True)
    inputs = tracker_inputs(state, dets, cfg, advance, embs)
    plain = _launch(emulated, "tracker", **inputs)
    clock = np.zeros((1, TC.CLOCK_COLUMNS), np.int64)
    got = _launch(emulated, "tracker", **inputs, clock=clock)
    clock = got.pop("clock")
    assert sorted(got) == sorted(plain)
    for k in plain:
        np.testing.assert_array_equal(got[k], plain[k], err_msg=k)
    n = len(TC.STAGES)
    assert (clock[0, :n] > 0).all() and clock[0, n] > 0
    split = TC.read_stage_clock(torch.from_numpy(clock), 12)
    assert abs(sum(split["share"].values()) - 1.0) < 1e-9


def _mutant(emulated, tmp_path, old, new, source="tracker_chunk.cu",
            opt="-O1", unit=None):
    """The emulated library with a kernel's source (Kernel 3's unless
    named) mutated (old -> new), compiled at g++ level `opt`; a mutated
    header (auction.cuh) is compiled into the source `unit` that includes
    it."""
    _, out = emulated
    with open(os.path.join(cuda_lib.CSRC, source)) as f:
        src = _to_cpp(f.read())
    bad = src.replace(old, new)
    assert bad != src
    mdir = tmp_path / "mutant"
    mdir.mkdir(exist_ok=True)
    if unit is not None:
        (mdir / source).write_text(bad)
        with open(os.path.join(cuda_lib.CSRC, unit)) as f:
            bad = _to_cpp(f.read())
    (mdir / "mutant.cpp").write_text(bad)
    lib = tmp_path / "libmutant.so"
    r = subprocess.run([shutil.which("g++"), "-std=c++20", opt, "-fPIC",
                        "-shared", "-pthread", "-ffp-contract=off", "-I",
                        str(out), "-o", str(lib), str(mdir / "mutant.cpp")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return str(lib), out


def test_tracker_kernel_mutation_is_caught(emulated, tmp_path):
    """A kernel with a broken rank rule (a new detection counts itself)
    must disagree with the plain version: the comparison above can fail."""
    mutant = _mutant(emulated, tmp_path,
                     "list_b[ob + __popc(bb & below)] = i;",
                     "list_b[ob + __popc(bb & (below | (1u << lane)))] = i;")
    state, dets, advance = tracker_case(1, 12, 32, 16, 12)
    cfg = TrackerConfig(max_tracks=32, max_detections=16)
    want_state, want_outs = TC.tracker_chunk_plain(state, dets, cfg, advance)
    with pytest.raises(AssertionError):   # a mismatch, or a crash
        got = _launch(mutant, "tracker",
                      **tracker_inputs(state, dets, cfg, advance))
        assert_tracker_equal(got, want_state, want_outs)


@pytest.mark.parametrize("old,new", [
    # every ballot rank counts the thread itself
    ("const unsigned below = (1u << lane) - 1u;",
     "const unsigned below = (2u << lane) - 1u;"),
    # the lists' warp offsets off by one warp (out of index order)
    ("      if (w < warp) {", "      if (w <= warp) {"),
    # the prefetched detections read before their copy is waited for
    ("      cp_async_wait<0>();\n", "      ;\n"),
])
def test_tracker_kernel_v2_mutation_is_caught(emulated, tmp_path, old,
                                               new):
    """A kernel with broken ranks, lists or prefetch must disagree with
    the plain version: the comparison above can fail. The case has T = 64
    (two warps of slots) and D = 16 (prefetched)."""
    mutant = _mutant(emulated, tmp_path, old, new)
    state, dets, advance = tracker_case(1, 12, 64, 16, 12)
    cfg = TrackerConfig(max_tracks=64, max_detections=16)
    want_state, want_outs = TC.tracker_chunk_plain(state, dets, cfg, advance)
    with pytest.raises(AssertionError):   # a mismatch, or a crash
        got = _launch(mutant, "tracker",
                      **tracker_inputs(state, dets, cfg, advance))
        assert_tracker_equal(got, want_state, want_outs)


def reid_case(seed, K, T, D, crowd):
    state, dets, advance = tracker_case(seed, K, T, D, crowd)
    embs = torch.from_numpy(reid_embeddings_case(seed, dets.valid.numpy()))
    return state, dets, advance, embs


@pytest.mark.parametrize("seed,K,T,D,crowd", [
    (1, 12, 32, 16, 12),        # advance holes, crowded frames
    (0, 12, 16, 16, 12),        # slot exhaustion
    (1, 5, 128, 64, 40),        # the main path's pool, crowded frames
])
def test_tracker_kernel_reid_source_matches_plain(emulated, seed, K, T, D,
                                                  crowd):
    """Kernel 3 with Re-ID (reid_weight 0.3, reid_ema 0.9): the cosine
    blend of tiers 1 and 3, the EMA of matched tracks and the new tracks'
    embeddings, against the plain version; the final embeddings within
    1e-4 like every float."""
    state, dets, advance, embs = reid_case(seed, K, T, D, crowd)
    cfg = TrackerConfig(max_tracks=T, max_detections=D, reid_weight=0.3)
    want_state, want_outs = TC.tracker_chunk_plain(state, dets, cfg, advance,
                                                   embs)
    got = _launch(emulated, "tracker",
                  **tracker_inputs(state, dets, cfg, advance, embs))
    assert_tracker_equal(got, want_state, want_outs)
    assert not advance.all() and want_outs["emit"].any()
    assert (want_state.embeddings.abs().sum(1) > 0).sum() >= 4


@pytest.mark.parametrize("old,new", [
    ("*plane = u / nrm;", "*plane = u;"),              # EMA without renorm
    ("te > 1e-12f && dq > 1e-12f", "te > 1e-12f"),   # not co-visible
    ("s.er[ti] = femb[di * 3];", ""),                 # new track's red
])
def test_tracker_kernel_reid_mutation_is_caught(emulated, tmp_path, old,
                                                new):
    """A kernel whose Re-ID arithmetic is broken must disagree with the
    plain version: the Re-ID comparison above can fail."""
    mutant = _mutant(emulated, tmp_path, old, new)
    state, dets, advance, embs = reid_case(1, 12, 32, 16, 12)
    cfg = TrackerConfig(max_tracks=32, max_detections=16, reid_weight=0.3)
    want_state, want_outs = TC.tracker_chunk_plain(state, dets, cfg, advance,
                                                   embs)
    got = _launch(mutant, "tracker",
                  **tracker_inputs(state, dets, cfg, advance, embs))
    with pytest.raises(AssertionError):
        assert_tracker_equal(got, want_state, want_outs)


def kalman_case(seed, K, T, D, crowd, reid):
    """tracker_case (advance holes, crowded frames) continued from the pool
    that the plain version leaves after 4 warm-up frames of the same scene,
    its covariances then drawn at random: x and y apart (the y velocity
    must take the x gain) and below 0.1, so that the free slots' sums of
    process noise keep the last bit of 0.1f * 0.1f (on a variance of 100
    it rounds away). With Re-ID also the detections' embeddings."""
    state, dets, advance = tracker_case(seed, K + 4, T, D, crowd)
    embs = torch.from_numpy(reid_embeddings_case(
        seed, dets.valid.numpy())) if reid else None
    cfg = TrackerConfig(max_tracks=T, max_detections=D,
                        motion_model="kalman136",
                        reid_weight=0.3 if reid else 0.0)
    part = [Detections(*(getattr(dets, f.name)[sl]
                         for f in dataclasses.fields(dets)))
            for sl in (slice(0, 4), slice(4, None))]
    state, _ = TC.tracker_chunk_plain(state, part[0], cfg, None,
                                      None if embs is None else embs[:4])
    assert state.active.any()
    state.kf_cov = torch.from_numpy(np.random.default_rng(seed).uniform(
        0.001, 0.1, (T, 136)).astype(np.float32))
    return (state, part[1], advance[4:],
            None if embs is None else embs[4:], cfg)


@pytest.mark.parametrize("seed,K,T,D,crowd,reid", [
    (1, 12, 32, 16, 12, False),     # advance holes, crowded frames
    (0, 12, 16, 16, 12, True),      # slot exhaustion, Re-ID
    (2, 12, 32, 16, 12, True),      # advance holes, Re-ID
    (2, 5, 128, 64, 40, False),     # the main path's pool, crowded frames
])
def test_tracker_kernel_kalman_source_matches_plain(emulated, seed, K, T, D,
                                                    crowd, reid):
    """Kernel 3's kalman136 variant (accel and jerk memories 0.9) against
    the plain version, with and without Re-ID: the filter's mean and
    covariance equal, every slot's predicted."""
    state, dets, advance, embs, cfg = kalman_case(seed, K, T, D, crowd, reid)
    want_state, want_outs = TC.tracker_chunk_plain(state, dets, cfg, advance,
                                                   embs)
    got = _launch(emulated, "tracker",
                  **tracker_inputs(state, dets, cfg, advance, embs))
    assert_tracker_equal(got, want_state, want_outs)
    assert not advance.all() and want_outs["emit"].any()


@pytest.mark.parametrize("old,new", [
    ("caj.x + cfg.noise[2]", "caj.x + 0.01f"),       # noise literal 0.01
    ("pv.w + (use ? Kv * iy : 0.0f)",                # y velocity with Ky
     "pv.w + (use ? 0.5f * Ky * iy : 0.0f)"),
    ("const float4 pv = fm[2 * i], aj = fm[2 * i + 1];",   # active only
     "if (!s.active[i / kNumKp]) { s.qx[i] = s.px[i]; s.qy[i] = s.py[i]; "
     "continue; } const float4 pv = fm[2 * i], aj = fm[2 * i + 1];"),
    ("        fm = sm;\n        fc = sc;\n", ""),   # no restore on advance 0
])
def test_tracker_kernel_kalman_mutation_is_caught(emulated, tmp_path, old,
                                                  new):
    """A kalman136 kernel with one of these faults must disagree with the
    plain version: the comparison above can fail."""
    mutant = _mutant(emulated, tmp_path, old, new)
    state, dets, advance, embs, cfg = kalman_case(1, 12, 32, 16, 12, False)
    want_state, want_outs = TC.tracker_chunk_plain(state, dets, cfg, advance)
    got = _launch(mutant, "tracker",
                  **tracker_inputs(state, dets, cfg, advance))
    with pytest.raises(AssertionError):
        assert_tracker_equal(got, want_state, want_outs)


def conv_case(seed, B, H, W, C, O, bias=True, ps=None, x_off=0,
              s_x=0.05):
    """Kernel 4's inputs: a float activation [B, C, H, W] (float32, NHWC
    memory with pixel stride ps >= x_off + C, channels x_off .. + C of a
    wider tensor when ps > C) whose values include exact .5 ties of s_x and
    values beyond the clamp, its int8 quantisation (channel-padded), packed
    int8 weights for k = 3 and 1, scale (and bias)."""
    rng = np.random.default_rng(seed)
    ps = ps or C
    full = rng.normal(0, 40 * s_x, (B, H, W, ps)).astype(np.float32)
    n = rng.integers(-140, 140, full.shape).astype(np.float32)
    ties = rng.uniform(size=full.shape) < 0.3
    full[ties] = ((n + np.float32(0.5)) * np.float32(s_x))[ties]
    x = torch.from_numpy(full).permute(0, 3, 1, 2)[:, x_off:x_off + C]
    sx = torch.tensor(s_x, dtype=torch.float32)
    wq = {k: CI.pack_weights(rng.integers(-127, 128, (O, C, k, k))
                             .astype(np.int8)) for k in (3, 1)}
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, O).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, O).astype(np.float32)) \
        if bias else None
    return dict(x=x, s_x=sx, xq=CI.quantize_activation(x, sx), wq=wq,
                scale=scale, bias=b, x_off=x_off)


DTYPES = (torch.int32, torch.bfloat16, torch.float32)
IN_TYPES = (torch.int8, torch.bfloat16, torch.float32)


def _conv_launch(lib, case, runs):
    """Emulated Kernel 4 on `case` for each (input dtype, k, stride,
    output dtype, tile_m) of runs, in one child process -> the outputs
    [B, Ho, Wo, O]."""
    full = case["x"].permute(0, 2, 3, 1)
    full = torch.as_strided(full, full.shape[:3] + (full.stride(2),),
                            full.stride(), full.storage_offset()
                            - case["x_off"])
    inputs = dict(x=case["xq"].numpy(), xf=full.numpy(),
                  xb=full.to(torch.bfloat16).view(torch.int16).numpy()
                  .view(np.uint16),
                  C=case["x"].shape[1], x_off=case["x_off"],
                  s_x=case["s_x"].numpy().reshape(1),
                  w3=case["wq"][3].numpy(), w1=case["wq"][1].numpy(),
                  scale=case["scale"].numpy(),
                  cfg=np.array([(IN_TYPES.index(it), k, s,
                                 CI._OUT_DTYPES.index(dt), tile)
                                for it, k, s, dt, tile in runs]))
    if case["bias"] is not None:
        inputs["bias"] = case["bias"].numpy()
    res = _launch(lib, "conv", **inputs)
    outs = []
    for i, run in enumerate(runs):
        out = torch.from_numpy(res[f"out{i}"])
        outs.append(out.view(torch.bfloat16) if run[3] == torch.bfloat16
                    else out)
    return outs


def _conv_equal(got, case, in_dtype, k, stride, dtype):
    """The emulated output equals the plain version's bit for bit: the
    int8 mode's on the quantised activation, the float mode's on the
    activation in in_dtype."""
    args = (case["wq"][k], case["scale"], case["bias"], k, stride, dtype)
    if in_dtype == torch.int8:
        want = CI.conv_int8_plain(case["xq"], *args)
    else:
        want = CI.conv_w8a8_plain(case["x"].to(in_dtype), case["s_x"], *args)
    want = want.permute(0, 2, 3, 1).contiguous()
    if dtype == torch.bfloat16:
        return torch.equal(got.view(torch.int16), want.view(torch.int16))
    return torch.equal(got, want)


@pytest.mark.parametrize("B,H,W,C,O,bias", [
    (1, 9, 7, 51, 51, True),       # ragged channels, a ragged pixel tile
    (2, 8, 8, 128, 128, False),    # the JAX kernel test's shape (3x3, s1)
    (1, 6, 5, 64, 1, True),        # the confidence head's one channel
    (3, 12, 12, 32, 70, True),     # several pixel tiles, two channel tiles
])
def test_conv_kernel_source_matches_plain(emulated, B, H, W, C, O, bias):
    """Kernel 4's int8 mode, all three instantiations, against its plain
    version: the int32 sums and the bf16 and float32 epilogues, bit for
    bit; each instantiation at each pixel tile."""
    case = conv_case(B * 1000 + C + O, B, H, W, C, O, bias)
    runs = [(torch.int8, k, s, dt, CI.TILES_M[i % 3])
            for k, s in CI.SHAPES for i, dt in enumerate(DTYPES)]
    for run, got in zip(runs, _conv_launch(emulated, case, runs)):
        assert _conv_equal(got, case, *run[:4]), run


@pytest.mark.parametrize("B,H,W,C,O,bias,ps,x_off", [
    (1, 9, 7, 51, 51, True, 51, 0),     # C = 51: 102-byte bf16 rows
    (2, 8, 8, 64, 64, False, 64, 0),    # 16-byte loads
    (1, 10, 9, 32, 70, True, 64, 32),   # c2f's channel slice y[:, 32:]
    (2, 5, 6, 16, 1, True, 48, 16),     # a slice, 16-byte loads, O = 1
    (1, 5, 40, 24, 64, True, 24, 0),    # 3x3 s1 wider than a 32-pixel tile
    (1, 6, 7, 96, 40, True, 96, 0),     # two 64-channel stages of a patch
])
def test_conv_kernel_float_mode_matches_plain(emulated, B, H, W, C, O, bias,
                                             ps, x_off):
    """Kernel 4's float mode (bf16 and float32 input quantised in its
    load, .5 ties and clamped values included) against its plain version,
    quantize_activation then conv_int8_plain: the int32 sums and the
    epilogue in the input's type, all three instantiations, each at each
    pixel tile per input type (3x3 through the patch of whole rows where
    the output width fits the tile, else tap by tap), bit for bit."""
    case = conv_case(B * 100 + C + O + x_off, B, H, W, C, O, bias, ps,
                     x_off)
    runs = [(it, k, s, dt, CI.TILES_M[(j + i) % 3])
            for j, it in enumerate((torch.bfloat16, torch.float32))
            for k, s in CI.SHAPES
            for i, dt in enumerate((torch.int32, it, torch.int32))]
    for run, got in zip(runs, _conv_launch(emulated, case, runs)):
        assert _conv_equal(got, case, *run[:4]), run


@pytest.mark.parametrize("old,new,dtype", [
    # the last reduction step is dropped
    ("step < steps; ++step", "step < steps - 1; ++step", torch.int32),
    # the taps' rows and columns swapped (a transposed 3x3 kernel)
    ("ix = ix0 + tap % KS", "ix = ix0 + tap / KS", torch.int32),
    # the bias is left out of the epilogue
    ("if (bias != nullptr) v = v + bias[n];", "", torch.bfloat16),
    # the bf16 rounding truncates instead of rounding to nearest even
    ("(u + 0x7fffu + ((u >> 16) & 1u)) >> 16", "u >> 16", torch.bfloat16),
])
def test_conv_kernel_mutation_is_caught(emulated, tmp_path, old, new,
                                        dtype):
    """Kernel 4 with one of these faults must disagree with its plain
    version: the comparison above can fail."""
    mutant = _mutant(emulated, tmp_path, old, new, source="conv_int8.cu",
                     opt="-O0")
    case = conv_case(7, 1, 9, 7, 51, 51)
    got, = _conv_launch(mutant, case, [(torch.int8, 3, 1, dtype, 32)])
    assert not _conv_equal(got, case, torch.int8, 3, 1, dtype)


@pytest.mark.parametrize("old,new,in_dtype,C", [
    # the quantisation rounds half away from zero (ties move)
    ("rintf(", "roundf(", torch.float32, 51),
    # the halo is not zeroed: the int8 copy reads 16 bytes of x instead
    ("src ? 16 : 0", "16", torch.int8, 51),
    # the halo is not zeroed in the float mode's register load
    ("src ? s.C - c0 : 0", "s.C - c0", torch.bfloat16, 51),
    # the halo is not zeroed in the patch's cp.async load (16-byte rows)
    ("const int n = in ? 2 * (s.C - c0) : 0;", "const int n = 16;",
     torch.bfloat16, 64),
    # the ldmatrix reads swizzle their rows off by one
    ("(lane >> 1) & 3", "((lane >> 1) + 1) & 3", torch.int8, 51),
    # the products read a stage before its copies have landed
    ("cp_async_wait<kStages - 2>();", "", torch.int8, 51),
    # the patch's taps lose their column offset
    ("st % T / KS * PW + st % KS", "st % T / KS * PW", torch.bfloat16, 51),
])
def test_conv_kernel_v2_mutation_is_caught(emulated, tmp_path, old, new,
                                           in_dtype, C):
    """Kernel 4 with a fault of its tensor-core pipeline, its patch or its
    fused quantisation must disagree with its plain version (int32 sums)."""
    mutant = _mutant(emulated, tmp_path, old, new, source="conv_int8.cu",
                     opt="-O0")
    case = conv_case(11, 1, 9, 7, C, 51)
    got, = _conv_launch(mutant, case, [(in_dtype, 3, 1, torch.int32, 32)])
    assert not _conv_equal(got, case, in_dtype, 3, 1, torch.int32)

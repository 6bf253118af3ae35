#!/usr/bin/env python3
"""Smoke run of posebyte_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line with its elapsed seconds:
  device       the card's name and power limit (nvidia-smi)
  build        nvcc builds the kernels in csrc/ (or loads the cached build)
  kernels      each kernel against its plain PyTorch version on the card, at
               the main path's shapes, on seeded inputs; outputs must be
               equal ("launches" here counts this phase's comparison and
               timing launches)
  main_path    PosePipeline on the card: yolov8n-pose, 640 input, bf16, raw u8
               ingest, 16 frames of 1280x720 from the synthetic scene,
               through process_frame and fetch_outputs; the kernels' launch
               counts must be 1 (NMS) and 3 (auction) per frame
  cpu_vs_card  8 frames in fp32 on the CPU (plain versions) and on the card
               (kernels): track ids equal, keypoints within 1e-2 px
Then a line {"kernels": [...]} with each kernel's launches, error, times
and bound, and last {"ok": true, "device": {...}}. Any failure raises and
exits non-zero before that line; a hang is cut by faulthandler.
"""
import faulthandler
import json
import os
import subprocess
import sys
import time

LIMIT_S = 840          # hard stop for a hung run
FRAMES = 16
CMP_FRAMES = 8
WIDTH, HEIGHT = 1280, 720
N_PERSONS = 6
SEED = 7
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def emit(phase, t0, **kw):
    print(json.dumps({"phase": phase,
                      "s": round(time.perf_counter() - t0, 3), **kw}),
          flush=True)


def cuda_ms(fn, reps):
    """Mean device ms per call over `reps` calls (CUDA events), after one
    warm-up call."""
    import torch
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


def nms_case(rng, n=256, n_valid=240, chain=30):
    """Score-sorted candidates as decode gives them: clusters of person
    poses with jitter (dense overlaps), a chain of shifted copies in which
    each suppresses the next (deeper than the TPU kernel's 24 sweeps), and
    an invalid tail."""
    import numpy as np
    from posebyte_tpu_torch.utils.synthetic import POSE_OFFSETS
    n_cl = n // 12
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
                      poses[..., 0].max(1), poses[..., 1].max(1)], -1)
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    return poses, boxes.astype(np.float32), valid


def auction_case(rng, R=128, C=64):
    """Tracker-tier cost matrix: quantised costs (exact ties), ~60% locked
    pairs (1e9), a fully locked row and column, inactive rows."""
    import numpy as np
    cost = np.round(rng.uniform(0, 1, (R, C)) * 8) / 8
    cost[rng.uniform(size=(R, C)) < 0.6] = 1e9
    cost[3, :] = 1e9
    cost[:, 5] = 1e9
    active = rng.uniform(size=R) > 0.1
    return cost.astype(np.float32), active


def nms_work(poses, boxes, valid, iou_thr):
    """(bytes, float32 operations) the keep mask needs on these inputs:
    each input read once, the mask written once; per valid pair j < k the
    box IoU (~12 operations) and, where IoU alone does not decide, ~8 per
    co-visible keypoint (subtract, square, add, scale, divide, exp, sum)."""
    from posebyte_tpu_torch.ops.geometry import boxes_iou_matrix
    n = valid.shape[0]
    nbytes = poses.numel() * 4 + boxes.numel() * 4 + 2 * n
    pair = (valid[:, None] & valid[None, :]).triu(1)
    iou = boxes_iou_matrix(boxes, boxes)
    vis = poses[..., 2] > 0.2
    covis = (vis[:, None, :] & vis[None, :, :]).sum(-1)
    need_oks = pair & (iou <= iou_thr)
    ops = 12 * int(pair.sum()) + 8 * int((covis * need_oks).sum())
    return nbytes, ops


def greedy_sweeps(poses, boxes, valid):
    """Jacobi sweeps the greedy solution needs (longest suppression chain
    + 1); the TPU kernel stops after 24."""
    import torch
    from posebyte_tpu_torch.core.structs import Detections
    from posebyte_tpu_torch.ops.nms import nms_overlap_matrix
    det = Detections(poses, boxes, torch.zeros_like(boxes[:, 0]), valid)
    dom = nms_overlap_matrix(det, 0.55, 0.55).triu(1)
    keep, prev, sweeps = valid, torch.zeros_like(valid), 0
    while not torch.equal(keep, prev):
        prev, keep = keep, valid & ~(dom & keep[:, None]).any(0)
        sweeps += 1
    return sweeps


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(t0):
    import numpy as np
    import torch
    from posebyte_tpu_torch.ops import assignment as A
    from posebyte_tpu_torch.ops import nms as N

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    rows = {}
    start = {"nms_keep": N.nms_keep_cuda.launches,
             "auction": A.auction_assign_cuda.launches}

    # ---- Kernel 1: NMS keep mask, N = 256 --------------------------------
    mism, sweeps = 0, 0
    cases = [nms_case(rng), nms_case(rng, chain=40), nms_case(rng, chain=0)]
    for p_np, b_np, v_np in cases:
        p, b, v = (torch.from_numpy(a).to(dev) for a in (p_np, b_np, v_np))
        got = N.nms_keep_cuda(p, b, v, 0.55, 0.55)
        want = N.nms_keep_plain(p, b, v, 0.55, 0.55)
        torch.cuda.synchronize()
        mism += int((got != want).sum())
        sweeps = max(sweeps, greedy_sweeps(p, b, v))
    p, b, v = (torch.from_numpy(a).to(dev) for a in cases[0])
    nbytes, ops = nms_work(p, b, v, 0.55)
    b_ms, b_by = bound(nbytes, ops)
    rows["nms_keep"] = {
        "name": "nms_keep", "route": "cuda",
        "source": "posebyte_tpu_torch/csrc/nms_keep.cu",
        "replaces": "posebyte_tpu/ops/pallas_kernels.py:226",
        "mismatches": mism, "max_abs_err": float(mism > 0),
        "ms": cuda_ms(lambda: N.nms_keep_cuda(p, b, v, 0.55, 0.55), 200),
        "plain_ms": cuda_ms(lambda: N.nms_keep_plain(p, b, v, 0.55, 0.55),
                            10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"N=256,sweeps={sweeps}", "bytes": nbytes, "ops": ops}

    # ---- Kernel 2: auction, 128 x 64 -------------------------------------
    mism, err, rounds = 0, 0, 0
    for _ in range(3):
        c_np, a_np = auction_case(rng)
        c, a = torch.from_numpy(c_np).to(dev), torch.from_numpy(a_np).to(dev)
        r1, c1 = A.auction_assign_cuda(c, a)
        r2, c2, rounds = A.auction_assign_rounds(c, a)
        torch.cuda.synchronize()
        mism += int((r1 != r2).sum()) + int((c1 != c2).sum())
        err = max(err, int((r1 - r2).abs().max()), int((c1 - c2).abs().max()))
    R, Cc = c.shape
    nbytes = R * Cc * 4 + R + 4 * (R + Cc)
    budget = A.auction_iterations(R)
    ops = 6 * R * Cc * rounds + (4 * R * Cc if rounds < budget else 0)
    b_ms, b_by = bound(nbytes, ops)
    rows["auction"] = {
        "name": "auction", "route": "cuda",
        "source": "posebyte_tpu_torch/csrc/auction.cu",
        "replaces": "posebyte_tpu/ops/pallas_kernels.py:98",
        "mismatches": mism, "max_abs_err": float(err),
        "ms": cuda_ms(lambda: A.auction_assign_cuda(c, a), 200),
        "plain_ms": cuda_ms(lambda: A.auction_assign(c, a), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"R={R},C={Cc}", "rounds": rounds, "bytes": nbytes,
        "ops": ops}

    done = {"nms_keep": N.nms_keep_cuda.launches,
            "auction": A.auction_assign_cuda.launches}
    emit("kernels", t0, kernels=[
        {"name": r["name"], "launches": done[k] - start[k],
         "mismatches": r["mismatches"],
         "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "shape": r["shape"]} for k, r in rows.items()])
    bad = {k: r["mismatches"] for k, r in rows.items() if r["mismatches"]}
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    return rows


def make_frames(n):
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame
    scene = SyntheticScene(N_PERSONS, WIDTH, HEIGHT, seed=SEED)
    gts, frames = [], []
    for _ in range(n):
        gt = scene.step()
        gts.append(gt)
        frames.append(render_frame(gt, WIDTH, HEIGHT))
    return gts, frames


def phase_main_path(t0, params, rows):
    import numpy as np
    import torch
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.ops.assignment import auction_assign_cuda
    from posebyte_tpu_torch.ops.nms import nms_keep_cuda
    from posebyte_tpu_torch.pipeline import PosePipeline

    gts, frames = make_frames(FRAMES)
    pipe = PosePipeline(PipelineConfig(), params)     # the card, bf16
    nms_keep_cuda.launches = 0
    auction_assign_cuda.launches = 0
    dets, tracks, ms = [], [], []
    for fr in frames:
        t = time.perf_counter()
        out = pipe.process_frame(fr)
        res = pipe.fetch_outputs(out, WIDTH, HEIGHT)
        ms.append((time.perf_counter() - t) * 1e3)
        dets.append(int(out["det_valid"].sum()))
        tracks.append(len(res))
        for r in res:
            if not (np.isfinite(r.keypoints).all() and np.isfinite(r.bbox)
                    .all()):
                raise SystemExit("non-finite track output")
    launches = {"nms_keep": nms_keep_cuda.launches,
                "auction": auction_assign_cuda.launches}
    # accuracy: every person of the last frame has a track within 10 px
    kp = np.stack([r.keypoints[:, :2] for r in res]) if res else \
        np.zeros((0, 17, 2), np.float32)
    errs = [float(np.abs(kp - g[None, :, :2]).mean(axis=(1, 2)).min())
            if len(kp) else float("inf") for g in gts[-1]]
    emit("main_path", t0, frames=FRAMES, dets_per_frame=dets,
         tracks_per_frame=tracks, launches=launches,
         ms_per_frame_after_warmup=float(np.mean(ms[4:])),
         ms_first_frame=ms[0], last_frame_kp_err_px=errs,
         peak_mem_mb=torch.cuda.max_memory_allocated() / 2**20)
    for k, r in rows.items():
        r["launches"] = launches[k]
    if launches != {"nms_keep": FRAMES, "auction": 3 * FRAMES}:
        raise SystemExit(f"main path launch counts {launches}, expected "
                         f"{FRAMES} and {3 * FRAMES}")
    if max(errs) > 10.0:
        raise SystemExit(f"tracks miss the synthetic people: {errs}")


def phase_cpu_vs_card(t0, params):
    import numpy as np
    from posebyte_tpu_torch.core import PipelineConfig
    from posebyte_tpu_torch.pipeline import PosePipeline

    _, frames = make_frames(CMP_FRAMES)
    cfg = PipelineConfig(precision="fp32")
    runs = {}
    for dev in ("cpu", "cuda"):
        pipe = PosePipeline(cfg, params, device=dev)
        runs[dev] = [pipe.fetch_outputs(pipe.process_frame(f), WIDTH, HEIGHT)
                     for f in frames]
    ids_equal, kp_err = True, 0.0
    for a, b in zip(runs["cpu"], runs["cuda"]):
        ids_equal &= [t.track_id for t in a] == [t.track_id for t in b]
        if len(a) == len(b) and a:
            kp_err = max(kp_err, float(np.abs(
                np.stack([t.keypoints for t in a])
                - np.stack([t.keypoints for t in b])).max()))
    emit("cpu_vs_card", t0, frames=CMP_FRAMES, ids_equal=ids_equal,
         tracks_per_frame=[len(r) for r in runs["cuda"]],
         max_kp_diff_px=kp_err)
    if not ids_equal or kp_err > 1e-2:
        raise SystemExit("the card and the CPU disagree")


def main():
    faulthandler.dump_traceback_later(LIMIT_S, exit=True)
    t0 = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.ops import cuda_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("device", t0, name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    t = time.perf_counter()
    path, build_s = cuda_lib.build()
    cuda_lib.load()
    emit("build", t0, build_s=build_s, cached=build_s == 0.0,
         load_s=time.perf_counter() - t, library=os.path.basename(path))

    rows = phase_kernels(t0)
    params, _ = load_params(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "assets",
        "yolov8n-pose-synthetic640.safetensors"))
    phase_main_path(t0, params, rows)
    phase_cpu_vs_card(t0, params)

    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for r in rows.values()]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Train the learned Re-ID head on synthetic identity-coloured scenes, after
scripts/train_reid.py of the JAX package (assets/reid-head-synthetic came
from it): InfoNCE over pairs of frames of one scene at a time offset,
positives the same identity across the pair, negatives every other figure
of the batch; Adam; the same flags and metrics file, on the CUDA card
unless --device cpu.

    python -m posebyte_tpu_torch.scripts.train_reid [--device cuda] \\
        [--steps 1200] [--out assets/reid-head-synthetic.safetensors]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

P_MAX = 6
GEOMETRIES = [(640, 360), (960, 540), (1280, 720), (640, 480)]


def make_pairs(n_pairs: int, target: int, seed0: int) -> dict:
    """Identity pairs: for each scene, two frames `gap` apart with random
    colours per identity and photometric noise. Returns numpy arrays:
    img_a / img_b [N, S, S, 3] u8 RGB letterboxed, poses_a / poses_b [N,
    P_MAX, 17, 3] in model coordinates, valid [N, P_MAX]."""
    from ..ops.preprocess import letterbox_params
    from ..utils.synthetic import SyntheticScene, render_frame
    from .train_synthetic import letterbox_host

    rng = np.random.default_rng(seed0)
    S = target
    out = {
        "img_a": np.zeros((n_pairs, S, S, 3), np.uint8),
        "img_b": np.zeros((n_pairs, S, S, 3), np.uint8),
        "poses_a": np.zeros((n_pairs, P_MAX, 17, 3), np.float32),
        "poses_b": np.zeros((n_pairs, P_MAX, 17, 3), np.float32),
        "valid": np.zeros((n_pairs, P_MAX), bool),
    }
    for i in range(n_pairs):
        w, h = GEOMETRIES[i % len(GEOMETRIES)]
        n_persons = int(rng.integers(2, P_MAX + 1))
        scene = SyntheticScene(
            n_persons, w, h, seed=seed0 + 31 * i,
            scale_range=(float(rng.uniform(70, 100)),
                         float(rng.uniform(110, 170))),
            speed=float(rng.uniform(2.0, 7.0)))
        colors = rng.integers(30, 256, (n_persons, 3))
        background = int(rng.integers(15, 90))
        gap = int(rng.integers(3, 12))
        frames_gt = [gt.copy() for gt in scene.frames(gap + 1)]
        scale, _, _, pad_x, pad_y = letterbox_params(w, h, target)
        for tag, gt in (("a", frames_gt[0]), ("b", frames_gt[gap])):
            frame = render_frame(gt, w, h, background=background,
                                 colors=colors)
            gain = rng.uniform(0.7, 1.3)
            sigma = rng.uniform(0.0, 6.0)
            frame = np.clip(frame.astype(np.float32) * gain
                            + rng.normal(0, sigma, frame.shape),
                            0, 255).astype(np.uint8)
            out[f"img_{tag}"][i] = letterbox_host(frame, target)
            for p, pose in enumerate(gt[:P_MAX]):
                q = pose.copy()
                q[:, :2] = q[:, :2] * scale + (pad_x, pad_y)
                out[f"poses_{tag}"][i, p] = q
        out["valid"][i, :n_persons] = True
    return out


def _embed(params, img_u8: torch.Tensor, poses: torch.Tensor):
    from ..models.reid_head import apply_reid_head
    from ..models.train import to_unit
    return apply_reid_head(params, to_unit(img_u8), poses)


def info_nce_loss(params: dict, batch: dict, temp: float = 0.1):
    """InfoNCE over a batch of scene pairs: each figure of frame A against
    every figure of frame B in the batch, by the tracker's co-visibility
    cosine (ops.reid.cosine_cost_matrix), its positive the same identity.
    batch: tensors img_a, img_b [N, S, S, 3] u8, poses_a, poses_b [N, P,
    17, 3], valid [N, P]."""
    from ..ops.reid import cosine_cost_matrix

    emb_a = _embed(params, batch["img_a"], batch["poses_a"])   # [N, P, 51]
    emb_b = _embed(params, batch["img_b"], batch["poses_b"])
    N, P = emb_a.shape[:2]
    sim = 1.0 - cosine_cost_matrix(emb_a.reshape(N * P, -1),
                                   emb_b.reshape(N * P, -1))
    v = batch["valid"].reshape(N * P)
    pair_ok = v[:, None] & v[None, :]
    logits = torch.where(pair_ok, sim / temp, -1e9)
    logp = torch.log_softmax(logits, dim=-1)
    per_anchor = -torch.diagonal(logp)
    return torch.where(v, per_anchor, 0.0).sum() / v.sum().clamp_min(1)


def eval_separation(params: dict, data: dict, device=None) -> dict:
    """Mean same-identity and different-identity co-visibility cosine on a
    held-out split, and top-1 identity retrieval accuracy, on the card
    unless device="cpu"."""
    from ..core.device import resolve_device
    from ..ops.reid import cosine_cost_matrix

    device = resolve_device(device)
    params = {k: torch.as_tensor(v).to(device) for k, v in params.items()}
    same, diff, hits, total = [], [], 0, 0
    with torch.inference_mode():
        for i in range(len(data["img_a"])):
            v = data["valid"][i]
            n = int(v.sum())
            if n < 2:
                continue
            emb = [_embed(params, torch.from_numpy(data[f"img_{t}"][i])
                          .to(device), torch.from_numpy(
                              data[f"poses_{t}"][i]).to(device))[:n]
                   for t in ("a", "b")]
            cos = (1.0 - cosine_cost_matrix(*emb)).cpu().numpy()
            same.extend(np.diag(cos))
            diff.extend(cos[~np.eye(n, dtype=bool)])
            hits += int((cos.argmax(axis=1) == np.arange(n)).sum())
            total += n
    return {"same_id_cos": float(np.mean(same)),
            "diff_id_cos": float(np.mean(diff)),
            "top1_acc": hits / max(total, 1), "anchors": total}


def make_step(data_dev: dict, n: int, batch_size: int, optimizer):
    """step(params, opt_state, generator) -> (params, opt_state, loss):
    batch_size distinct pairs drawn from `generator` (on the device), one
    update of `optimizer` on info_nce_loss's gradients."""
    from ..models.optim import apply_updates

    def step(params, opt_state, gen):
        idx = torch.randperm(n, generator=gen, device=gen.device)[:batch_size]
        batch = {k: v.index_select(0, idx) for k, v in data_dev.items()}
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = info_nce_loss(leaves, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        updates, opt_state = optimizer.update(
            dict(zip(leaves, grads)), opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    return step


def build_parser():
    p = argparse.ArgumentParser(prog="train_reid")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--n-train", type=int, default=768)
    p.add_argument("--n-val", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="assets/reid-head-synthetic"
                                    ".safetensors")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default: the CUDA card) or 'cpu'")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..core.device import resolve_device, set_numeric_settings
    from ..models import optim
    from ..models.reid_head import init_reid_head, save_reid_head

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e)) from e
    set_numeric_settings()
    print(f"device: {dev}", flush=True)
    t0 = time.time()
    train = make_pairs(args.n_train, args.size, args.seed)
    val = make_pairs(args.n_val, args.size, args.seed + 999_000)
    print(f"dataset: {args.n_train} train / {args.n_val} val pairs in "
          f"{time.time() - t0:.1f}s", flush=True)

    params = {k: v.to(dev) for k, v in init_reid_head(args.seed).items()}
    optimizer = optim.adam(args.lr)
    opt_state = optimizer.init(params)
    data_dev = {k: torch.from_numpy(v).to(dev) for k, v in train.items()}
    step = make_step(data_dev, args.n_train, args.batch, optimizer)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)

    t0 = time.time()
    for it in range(args.steps):
        params, opt_state, loss = step(params, opt_state, gen)
        if (it + 1) % 200 == 0:
            print(f"step {it + 1:5d}/{args.steps}  loss "
                  f"{float(loss):.4f}  "
                  f"({(time.time() - t0) / (it + 1) * 1e3:.0f} ms/step)",
                  flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_reid_head(params, args.out)
    print(f"saved {args.out}", flush=True)

    metrics = eval_separation(params, val, dev)
    print("val separation:", json.dumps(
        {k: round(v, 4) if isinstance(v, float) else v
         for k, v in metrics.items()}), flush=True)
    with open(args.out.replace(".safetensors", ".metrics.json"),
              "w") as f:
        json.dump({"val": metrics, "steps": args.steps,
                   "train_pairs": args.n_train, "size": args.size},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

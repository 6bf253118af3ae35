"""The plain reference of everything around the model: the letterbox, the
sparse decode, pose NMS and the two-tier pose tracker with its per-frame
outputs, written from the algorithm's definition in PyTorch (letterbox,
decode) and NumPy (NMS, tracker). It imports nothing of the program under
test.

Letterbox: bilinear two-tap sampling, src = (t - pad) / scale clamped to
[0, n - 1.001], RGB, /255, gray 114/255 outside the content.
Decode: confidence sigmoid(cls) >= conf_threshold, the top max_candidates
by confidence (ties to the lower anchor), the DFL expectation over 16
bins for the box, keypoints (2 raw + anchor - 0.5) * stride.
NMS: greedy in score order; i suppresses j where their box IoU exceeds
iou_threshold, or where at least 3 keypoints (conf > 0.2) are visible in
both and their OKS exceeds oks_threshold (or 0.4 with IoU above 0.2).
Tracker: constant-velocity prediction, a velocity-adaptive spatial gate,
three association tiers (full-body OKS on tracks not lost, torso OKS, lost
tracks with a wider gate), each an auction; a constant-gain update,
ageing, new tracks in detection order and duplicate suppression; a
detection's track is emitted once confirmed (or tentative with min_hits).
"""
from __future__ import annotations

import numpy as np
import torch

from .model import REG_MAX

SIGMAS = np.array([0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072,
                   0.072, 0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089,
                   0.089], np.float32)
TORSO = np.array([5, 6, 11, 12])
TENTATIVE, CONFIRMED, LOST = 0, 1, 2
LOCK = np.float32(1e9)


def letterbox_geometry(width: int, height: int, target: int):
    scale = min(target / width, target / height)
    new_w, new_h = int(width * scale), int(height * scale)
    return scale, new_w, new_h, (target - new_w) // 2, (target - new_h) // 2


def letterbox(frames_u8: torch.Tensor, target: int) -> torch.Tensor:
    """BGR u8 frames [N, H, W, 3] -> normalised RGB [N, 3, target,
    target] float32 by bilinear sampling."""
    N, H, W, _ = frames_u8.shape
    scale, new_w, new_h, px, py = letterbox_geometry(W, H, target)
    dev = frames_u8.device

    def axis(n_in, pad):
        t = np.arange(target, dtype=np.float64)
        src = np.clip((t - pad) / scale, 0.0, n_in - 1.001)
        i0 = src.astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        w1 = torch.from_numpy((src - i0).astype(np.float32)).to(dev)
        return (torch.from_numpy(i0).to(dev), torch.from_numpy(i1).to(dev),
                w1)

    y0, y1, wy = axis(H, py)
    x0, x1, wx = axis(W, px)
    img = frames_u8.float()
    rows = img[:, y0] * (1 - wy)[None, :, None, None] \
        + img[:, y1] * wy[None, :, None, None]
    out = rows[:, :, x0] * (1 - wx)[None, None, :, None] \
        + rows[:, :, x1] * wx[None, None, :, None]
    out = out.flip(-1) / 255.0
    t = torch.arange(target, device=dev)
    inside = ((t[:, None] >= py) & (t[:, None] < py + new_h)
              & (t[None, :] >= px) & (t[None, :] < px + new_w))
    out = torch.where(inside[None, :, :, None], out,
                      torch.tensor(114.0 / 255.0, device=dev))
    return out.permute(0, 3, 1, 2).contiguous()


def decode(box, cls, kpt, anchor_xy, strides, conf_threshold: float,
           max_candidates: int):
    """Head outputs of a batch -> per image (poses [k, 17, 3], boxes [k, 4]
    xyxy, scores [k]) numpy, score-descending, k <= max_candidates."""
    conf = torch.sigmoid(cls[..., 0].float())
    out = []
    for b in range(conf.shape[0]):
        c = conf[b]
        idx = torch.nonzero(c >= conf_threshold)[:, 0]
        order = torch.argsort(-c[idx], stable=True)
        idx = idx[order][:max_candidates]
        prob = torch.softmax(box[b, idx].float().reshape(-1, 4, REG_MAX), -1)
        d = (prob * torch.arange(REG_MAX, device=c.device)).sum(-1)
        a, s = anchor_xy[idx], strides[idx][:, None]
        boxes = torch.cat([(a - d[:, :2]) * s, (a + d[:, 2:]) * s], -1)
        k3 = kpt[b, idx].float().reshape(-1, 17, 3)
        kxy = (k3[..., :2] * 2.0 + (a[:, None, :] - 0.5)) * s[:, :, None]
        poses = torch.cat([kxy, torch.sigmoid(k3[..., 2:3])], -1)
        out.append((poses.cpu().numpy(), boxes.cpu().numpy(),
                    c[idx].cpu().numpy()))
    return out


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = ix * iy
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def nms(poses, boxes, scores, iou_threshold: float, oks_threshold: float,
        max_keep: int):
    """Greedy pose NMS over score-descending candidates -> the kept ones,
    at most max_keep, in score order."""
    n = len(scores)
    if n == 0:
        return poses, boxes, scores
    iou = box_iou(boxes, boxes)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    scale2 = 2.0 * np.maximum(np.maximum(area[:, None], area[None, :]),
                              32.0 * 32.0)
    d2 = ((poses[:, None, :, :2] - poses[None, :, :, :2]) ** 2).sum(-1)
    vis = (poses[:, None, :, 2] > 0.2) & (poses[None, :, :, 2] > 0.2)
    oks_kp = np.exp(-d2 / (scale2[..., None] * 4.0 * SIGMAS ** 2))
    count = vis.sum(-1)
    oks = np.where(count >= 3, (oks_kp * vis).sum(-1)
                   / np.maximum(count, 1), 0.0)
    overlap = (iou > iou_threshold) | ((count >= 3) & (
        (oks > oks_threshold) | ((oks > 0.4) & (iou > 0.2))))
    keep = []
    for i in range(n):
        if not any(overlap[j, i] for j in keep):
            keep.append(i)
    keep = np.asarray(keep[:max_keep], np.int64)
    return poses[keep], boxes[keep], scores[keep]


# ---------------------------------------------------------------- tracker

def _boxes_of(poses, thresh=0.1):
    """Box of the keypoints above thresh and its validity (>= 2)."""
    m = poses[..., 2] > thresh
    xy = poses[..., :2]
    mn = np.where(m[..., None], xy, 1e9).min(-2)
    mx = np.where(m[..., None], xy, -1e9).max(-2)
    valid = m.sum(-1) >= 2
    return np.where(valid[..., None], np.concatenate([mn, mx], -1), 0.0), \
        valid


def centers(poses):
    box, valid = _boxes_of(poses)
    c = np.stack([(box[..., 0] + box[..., 2]) * 0.5,
                  (box[..., 1] + box[..., 3]) * 0.5,
                  box[..., 2] - box[..., 0], box[..., 3] - box[..., 1]], -1)
    return np.where(valid[..., None], c, 0.0).astype(np.float32)


def gate(tc, dc, vel, active, states, threshold):
    degenerate = ((tc[:, None, 2] < 1) | (tc[:, None, 3] < 1)
                  | (dc[None, :, 2] < 1) | (dc[None, :, 3] < 1))
    dist = np.sqrt(((tc[:, None, :2] - dc[None, :, :2]) ** 2).sum(-1))
    size = (tc[:, None, 2] + tc[:, None, 3] + dc[None, :, 2]
            + dc[None, :, 3]) * 0.25
    ratio = dist / (size + 1e-6)
    speed = np.sqrt((vel[:, TORSO] ** 2).sum(-1)).sum(-1) * 0.25
    thr = threshold * (1.0 + np.minimum(speed[:, None] / (size + 1e-6), 2.0))
    thr = np.where((states == LOST)[:, None], thr * 2.0, thr)
    return (degenerate | (ratio < thr)) & active[:, None]


def _area(poses):
    m = poses[..., 2] > 0.1
    mn = np.where(m[..., None], poses[..., :2], 1e9).min(-2)
    mx = np.where(m[..., None], poses[..., :2], -1e9).max(-2)
    a = (mx[..., 0] - mn[..., 0]) * (mx[..., 1] - mn[..., 1])
    return np.where(m.any(-1), np.maximum(a, 0.0), 0.0)


def oks(tp, dp, vis_thr, sigma_scale=2.0, min_scale_sq=1000.0, min_count=3):
    s2 = np.maximum((_area(tp)[:, None] + _area(dp)[None, :]) * 0.5,
                    min_scale_sq)
    d2 = ((tp[:, None, :, :2] - dp[None, :, :, :2]) ** 2).sum(-1)
    e = np.exp(-d2 / (2.0 * s2[..., None] * (sigma_scale * SIGMAS) ** 2))
    vis = (tp[:, None, :, 2] > vis_thr) & (dp[None, :, :, 2] > vis_thr)
    n = vis.sum(-1)
    return np.where(n >= min_count, (e * vis).sum(-1) / np.maximum(n, 1), 0.0)


def torso_oks(tp, dp):
    t, d = tp[:, TORSO], dp[:, TORSO]
    d2 = ((t[:, None, :, :2] - d[None, :, :, :2]) ** 2).sum(-1)
    e = np.exp(-d2 / (2.0 * 10000.0 * (3.0 * SIGMAS[TORSO]) ** 2))
    vis = (t[:, None, :, 2] > 0.1) & (d[None, :, :, 2] > 0.1)
    n = vis.sum(-1)
    return np.where(n >= 2, (e * vis).sum(-1) / np.maximum(n, 1), 0.0)


def auction(cost, active):
    """The Jacobi auction of the tracker's tiers: unassigned active rows
    bid best - second + eps on their best column (rows whose best value is
    a lock do not bid), each column goes to its highest bid (ties to the
    lower row) and its price rises by it; eps from 1 / (R + 1), x0.9 per
    round, at most min(3R, 50) rounds."""
    R, Cn = cost.shape
    row = np.full(R, -1, np.int64)
    col = np.full(Cn, -1, np.int64)
    price = np.zeros(Cn, np.float32)
    eps = np.float32(1.0 / (R + 1))
    for _ in range(min(3 * R, 50)):
        value = -cost - price[None, :]
        best = value.argmax(1)
        best_val = value.max(1)
        bidder = (row < 0) & active & (best_val > -1e8)
        if not bidder.any():
            break
        second = value.copy()
        second[np.arange(R), best] = -1e9
        bid = best_val - second.max(1) + eps
        bm = np.full((R, Cn), -1e9, np.float32)
        rows = np.nonzero(bidder)[0]
        bm[rows, best[rows]] = bid[rows]
        col_best = bm.max(0)
        won = col_best > -5e8
        col = np.where(won, bm.argmax(0), col)
        price = np.where(won, price + col_best, price).astype(np.float32)
        row = np.full(R, -1, np.int64)
        owner = np.nonzero(col >= 0)[0]
        row[col[owner]] = owner
        eps = np.float32(eps * np.float32(0.9))
    return row, col


class Tracker:
    """The tracker's state over T slots and its per-frame step."""

    def __init__(self, cfg: dict, state: dict | None = None):
        self.cfg = cfg
        T, D = cfg["max_tracks"], cfg["max_detections"]
        self.T, self.D = T, D
        if state is None:
            state = {"poses": np.zeros((T, 17, 3), np.float32),
                     "velocities": np.zeros((T, 17, 2), np.float32),
                     "ids": np.zeros(T, np.int64),
                     "states": np.zeros(T, np.int64),
                     "hits": np.zeros(T, np.int64),
                     "ages": np.zeros(T, np.int64),
                     "active": np.zeros(T, bool), "next_id": 1}
        self.s = state

    def step(self, det_poses, det_scores):
        """One frame's detections (score order, n <= D) -> the emitted
        tracks: a list of (id, score, pose [17, 3]) in detection order."""
        c, s = self.cfg, self.s
        T, D = self.T, self.D
        n = len(det_scores)
        dp = np.zeros((D, 17, 3), np.float32)
        dp[:n] = det_poses
        dscore = np.zeros(D, np.float32)
        dscore[:n] = det_scores
        dvalid = np.arange(D) < n
        act, states = s["active"], s["states"]
        lost = (states == LOST) & act
        pred = s["poses"].copy()
        pred[..., :2] = np.where(act[:, None, None],
                                 s["poses"][..., :2] + s["velocities"],
                                 s["poses"][..., :2])
        vel = np.where(lost[:, None, None], s["velocities"] * np.float32(0.95),
                       s["velocities"]).astype(np.float32)
        tc, dc = centers(pred), centers(dp)
        g = gate(tc, dc, vel, act, states, c["gate_threshold"]) \
            & dvalid[None, :]
        gate1 = g & (act & (states != LOST))[:, None]

        def tier(cost, row, col):
            locked = (row >= 0)[:, None] | (col >= 0)[None, :]
            r2, c2 = auction(np.where(locked, LOCK, cost).astype(np.float32),
                             act)
            return np.where(row >= 0, row, r2), np.where(col >= 0, col, c2)

        # the costs of active tracks and valid detections (every other
        # pair is gated out)
        sub = np.ix_(np.nonzero(act)[0], np.arange(n))

        def cost(g, sim):
            out = np.full((T, D), LOCK, np.float32)
            out[sub] = np.where(g[sub], 1.0 - sim(pred[sub[0][:, 0]], dp[:n]),
                                LOCK)
            return out

        row = np.full(T, -1, np.int64)
        col = np.full(D, -1, np.int64)
        row, col = tier(cost(gate1, lambda t, d: oks(
            t, d, c["visibility_threshold"])), row, col)
        row, col = tier(cost(gate1, torso_oks), row, col)
        lg = gate(tc, dc, vel, act, states,
                  c["gate_threshold"] * c["lost_gate_scale"]) \
            & lost[:, None] & dvalid[None, :]
        row, col = tier(cost(lg, lambda t, d: oks(t, d, 0.2)), row, col)

        matched = (row >= 0) & act
        di = np.clip(row, 0, D - 1)
        gain = np.float32(c["measurement_noise"]
                          / (c["measurement_noise"] + c["process_noise"]))
        # the update starts from the state's poses, not the prediction,
        # which only serves the association
        innov = dp[di, :, :2] - s["poses"][..., :2]
        poses = s["poses"].copy()
        poses[..., :2] = np.where(matched[:, None, None],
                                  s["poses"][..., :2] + gain * innov,
                                  s["poses"][..., :2])
        poses[..., 2] = np.where(matched[:, None], dp[di, :, 2],
                                 s["poses"][..., 2])
        a = np.float32(c["velocity_alpha"])
        vel = np.where(matched[:, None, None], a * innov + (1 - a) * vel,
                       vel).astype(np.float32)
        hits = np.where(matched, s["hits"] + 1, s["hits"])
        ages = np.where(matched, 0, s["ages"])
        promote = matched & (((states == TENTATIVE)
                              & (hits >= c["min_hits"]))
                             | (states == LOST))
        states = np.where(promote, CONFIRMED, states)
        unmatched = ~matched & act
        ages = np.where(unmatched, ages + 1, ages)
        dead = unmatched & (((states == TENTATIVE)
                             & (ages > c["tentative_max_age"]))
                            | ((states == LOST)
                               & (ages > c["max_age"] + c["lost_window"])))
        states = np.where(unmatched & (states == CONFIRMED)
                          & (ages > c["max_age"]), LOST, states)
        active = act & ~dead

        ids = s["ids"].copy()
        next_id = s["next_id"]
        free = list(np.nonzero(~active)[0])
        for d in range(n):
            if col[d] >= 0 or dscore[d] < c["new_track_thresh"] \
                    or not free:
                continue
            t = free.pop(0)
            poses[t], vel[t] = dp[d], 0.0
            ids[t], hits[t], ages[t] = next_id, 1, 0
            states[t], active[t] = TENTATIVE, True
            col[d] = t
            next_id += 1

        # duplicates: of two eligible tracks whose gating-time centre
        # boxes overlap by IoU > dedup_iou, the one with fewer hits (or,
        # on equal hits, the higher id) goes
        elig = active & (states != LOST) & (hits >= c["min_hits"])
        half = tc[:, 2:4] * 0.5
        xyxy = np.concatenate([tc[:, :2] - half, tc[:, :2] + half], -1)
        dup = (elig[:, None] & elig[None, :] & ~np.eye(T, dtype=bool)
               & (box_iou(xyxy, xyxy) > c["dedup_iou_threshold"]))
        loses = (hits[:, None] < hits[None, :]) | (
            (hits[:, None] == hits[None, :]) & (ids[:, None] > ids[None, :]))
        active = active & ~(dup & loses).any(1)

        self.s = {"poses": poses.astype(np.float32), "velocities": vel,
                  "ids": ids, "states": states, "hits": hits, "ages": ages,
                  "active": active, "next_id": next_id}
        out = []
        for d in range(n):
            t = col[d]
            if t < 0 or not active[t] or states[t] == LOST or (
                    states[t] == TENTATIVE and hits[t] < c["min_hits"]):
                continue
            out.append((int(ids[t]), float(dscore[d]), poses[t].copy()))
        return out


def to_frame(pose: np.ndarray, width: int, height: int, target: int):
    """A pose in model input pixels -> frame pixels, with its keypoint box
    (conf > 0.2, padded by 10% a side) -> (pose [17, 3], box [4])."""
    scale, _, _, px, py = letterbox_geometry(width, height, target)
    m = pose[:, 2] > 0.2
    box = np.zeros(4, np.float32)
    if m.any():
        mn, mx = pose[m, :2].min(0), pose[m, :2].max(0)
        pad = (mx - mn) * np.float32(0.1)
        box = np.concatenate([mn - pad, mx + pad])
    off = np.array([px, py], np.float32)
    out = pose.copy()
    out[:, :2] = (pose[:, :2] - off) / np.float32(scale)
    box = np.concatenate([box[:2] - off, box[2:] - off]) / np.float32(scale)
    return out, box.astype(np.float32)

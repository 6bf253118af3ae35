"""Synthetic scenes and a numpy skeleton rasteriser, so that frames with
people in them can be made without cv2.

SyntheticScene and CrowdedScene are posebyte_tpu/utils/synthetic.py's
scenes (the same motion and the same poses for the same seed).
render_frame follows its render_frame/draw_pose (utils/video.py:134-147):
skeleton edges as 2-px lines, keypoints as filled discs of radius 3,
per-person colours. It does not match cv2 pixel for pixel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import constants as C
from ..core.device import resolve_device
from ..core.structs import Detections

# Human-shaped keypoint offsets, unit scale (reference benchmark.cpp:19-66).
POSE_OFFSETS = np.array([
    (0.0, -0.45), (-0.05, -0.5), (0.05, -0.5), (-0.1, -0.48),
    (0.1, -0.48), (-0.2, -0.3), (0.2, -0.3), (-0.25, -0.1),
    (0.25, -0.1), (-0.25, 0.1), (0.25, 0.1), (-0.15, 0.05),
    (0.15, 0.05), (-0.15, 0.3), (0.15, 0.3), (-0.15, 0.5),
    (0.15, 0.5),
], dtype=np.float32)


class SyntheticScene:
    """Deterministic multi-person scene with bouncing linear motion: poses
    [P, 17, 3] float32 in frame pixels, confidence 1.0, figures placed on a
    spread-out grid."""

    def __init__(self, n_persons: int = 3, width: int = 1280,
                 height: int = 720, seed: int = 42,
                 scale_range=(90.0, 140.0), speed: float = 4.0):
        self.width, self.height = width, height
        rng = np.random.default_rng(seed)
        self.scales = rng.uniform(*scale_range, size=n_persons) \
            .astype(np.float32)
        margin = float(self.scales.max()) * 0.6 + 8.0
        cols = int(np.ceil(np.sqrt(n_persons)))
        rows = int(np.ceil(n_persons / cols))
        xs = np.linspace(margin, width - margin, cols)
        ys = np.linspace(margin, height - margin, rows)
        centers = []
        for i in range(n_persons):
            cx = xs[i % cols] + rng.uniform(-10, 10)
            cy = ys[i // cols] + rng.uniform(-10, 10)
            centers.append((cx, cy))
        self.centers = np.asarray(centers, np.float32)
        ang = rng.uniform(0, 2 * np.pi, size=n_persons)
        self.vels = np.stack([np.cos(ang), np.sin(ang)],
                             axis=-1).astype(np.float32) * speed
        self.margin = margin

    @property
    def n_persons(self) -> int:
        return len(self.centers)

    def step(self) -> np.ndarray:
        """Advance one frame; returns the poses [P, 17, 3]."""
        self.centers += self.vels
        lo = self.margin
        hix, hiy = self.width - self.margin, self.height - self.margin
        bounce_x = (self.centers[:, 0] < lo) | (self.centers[:, 0] > hix)
        bounce_y = (self.centers[:, 1] < lo) | (self.centers[:, 1] > hiy)
        self.vels[bounce_x, 0] *= -1
        self.vels[bounce_y, 1] *= -1
        self.centers[:, 0] = np.clip(self.centers[:, 0], lo, hix)
        self.centers[:, 1] = np.clip(self.centers[:, 1], lo, hiy)
        poses = np.ones((self.n_persons, 17, 3), np.float32)
        poses[:, :, :2] = (self.centers[:, None, :]
                           + POSE_OFFSETS[None] * self.scales[:, None, None])
        return poses

    def frames(self, n: int):
        """Yield n pose arrays."""
        for _ in range(n):
            yield self.step()


def pose_bbox(pose: np.ndarray, pad: float = 0.12) -> np.ndarray:
    """Tight xyxy box around a [17, 3] pose, padded by `pad` x extent
    (posebyte_tpu/utils/synthetic.py::pose_bbox)."""
    x1, y1 = pose[:, 0].min(), pose[:, 1].min()
    x2, y2 = pose[:, 0].max(), pose[:, 1].max()
    dx, dy = (x2 - x1) * pad, (y2 - y1) * pad
    return np.asarray([x1 - dx, y1 - dy, x2 + dx, y2 + dy], np.float32)


def poses_to_arrays(poses: np.ndarray, capacity: int, score=0.9):
    """Poses [P, 17, 3] -> padded detection arrays (poses [capacity, 17,
    3], boxes [capacity, 4], scores [capacity], valid [capacity]), the
    layout of posebyte_tpu/utils/synthetic.py::poses_to_detections.
    `score` is one value or one per pose."""
    P = len(poses)
    assert P <= capacity
    dp = np.zeros((capacity, 17, 3), np.float32)
    db = np.zeros((capacity, 4), np.float32)
    ds = np.zeros((capacity,), np.float32)
    dv = np.zeros((capacity,), bool)
    dp[:P] = poses
    for i, pose in enumerate(poses):
        db[i] = pose_bbox(pose)
    ds[:P] = score
    dv[:P] = True
    return dp, db, ds, dv


def poses_to_detections(poses: np.ndarray, capacity: int, score=0.9,
                        device=None) -> Detections:
    """Poses [P, 17, 3] -> padded Detections of `capacity` on `device`
    (None: the card), the detector bypass of
    posebyte_tpu/utils/synthetic.py::poses_to_detections."""
    dev = resolve_device(device)
    return Detections(*(torch.from_numpy(a).to(dev)
                        for a in poses_to_arrays(poses, capacity, score)))


def tracker_chunk_case(seed: int, frames: int, capacity: int,
                       n_persons: int = 6, width: int = 1280,
                       height: int = 720, crowd: int = 0):
    """Stacked detection arrays [K, capacity, ...] and an advance mask [K]
    that put the tracker through its stages: a moving scene with keypoint
    jitter, random dropouts and low-confidence keypoints, a person gone
    long enough to be lost and found again, a near-duplicate detection
    (dedup), empty frames, frames crowded with up to `crowd` unrelated
    poses (new tracks, slot exhaustion), scores above and below the
    new-track threshold, and holes in the advance mask."""
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(n_persons, width, height, seed=seed)
    out = [[], [], [], []]
    for k in range(frames):
        gt = scene.step()
        keep = rng.uniform(size=n_persons) > 0.15
        if frames // 4 <= k < frames // 4 + 14:
            keep[0] = False                        # lost, then found
        poses = gt[keep].copy()
        poses[..., :2] += rng.normal(0, 1.5, poses[..., :2].shape)
        poses[..., 2] = rng.uniform(0.05, 1.0, poses[..., 2].shape)
        if k % 4 == 1 and len(poses):              # near-duplicate
            poses = np.concatenate([poses, poses[:1] + 2.0])
        if crowd and k % 5 in (3, 4):              # crowded frames
            extra = rng.uniform(60, min(width, height) - 60, (crowd, 1, 2)) \
                + POSE_OFFSETS[None] * rng.uniform(40, 90, (crowd, 1, 1))
            extra = np.concatenate(
                [extra, rng.uniform(0.3, 1.0, (crowd, 17, 1))], -1)
            poses = np.concatenate([poses, extra.astype(np.float32)])
        if k % 11 == 7:                            # empty frame
            poses = poses[:0]
        poses = poses[:capacity].astype(np.float32)
        scores = rng.uniform(0.1, 1.0, len(poses)).astype(np.float32)
        order = np.argsort(-scores, kind="stable")
        for lst, a in zip(out, poses_to_arrays(poses[order], capacity,
                                               scores[order])):
            lst.append(a)
    advance = rng.uniform(size=frames) > 0.2
    return tuple(np.stack(a) for a in out), advance


def auction_case(rng: np.random.Generator, R: int = 128, C: int = 64):
    """A tracker tier's cost matrix [R, C] float32 under stress, and its
    active rows [R] bool: quantised costs (exact ties), ~60% locked pairs
    (1e9), a fully locked row and column, ~10% inactive rows."""
    cost = np.round(rng.uniform(0, 1, (R, C)) * 8) / 8
    cost[rng.uniform(size=(R, C)) < 0.6] = 1e9
    cost[3, :] = 1e9
    cost[:, 5] = 1e9
    active = rng.uniform(size=R) > 0.1
    return cost.astype(np.float32), active


def nms_case(rng: np.random.Generator, n: int = 256, n_valid: int = 240,
             chain: int = 30):
    """Score-sorted NMS candidates as decode gives them, (poses [n, 17, 3],
    boxes [n, 4] float32, valid [n] bool): clusters of person poses with
    jitter (dense overlaps), a chain of shifted copies in which each
    suppresses the next (deeper than the TPU kernel's 24 sweeps), and an
    invalid tail."""
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


def reid_embeddings_case(seed: int, valid: np.ndarray,
                         occlusion: float = 0.3) -> np.ndarray:
    """Appearance embeddings [..., D, 51] float32 for detections with the
    validity mask `valid` [..., D], in the layout both Re-ID sources give
    (ops/reid.py): normal keypoint blocks, a share `occlusion` of them zero
    (keypoints not visible), L2-normalised over the 51 components; zero for
    invalid detections."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=valid.shape + (C.NUM_KEYPOINTS, 3))
    e[rng.random(valid.shape + (C.NUM_KEYPOINTS,)) < occlusion] = 0.0
    e = e.reshape(*valid.shape, C.NUM_KEYPOINTS * 3).astype(np.float32)
    e /= np.maximum(np.linalg.norm(e, axis=-1, keepdims=True), 1e-6)
    e[~valid] = 0.0
    return e.astype(np.float32)


def _paint(frame, ys, xs, mask, color):
    frame[ys[mask], xs[mask]] = color


def _draw_segment(frame, a, b, color, half_width: float = 1.5):
    """Pixels whose centre lies within half_width of segment a-b (1.5 comes
    closest to cv2.line with thickness 2)."""
    h, w = frame.shape[:2]
    x0 = max(int(np.floor(min(a[0], b[0]) - half_width)), 0)
    x1 = min(int(np.ceil(max(a[0], b[0]) + half_width)), w - 1)
    y0 = max(int(np.floor(min(a[1], b[1]) - half_width)), 0)
    y1 = min(int(np.ceil(max(a[1], b[1]) + half_width)), h - 1)
    if x0 > x1 or y0 > y1:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    d = np.asarray(b, np.float64) - np.asarray(a, np.float64)
    px, py = xs - a[0], ys - a[1]
    den = float(d @ d)
    t = np.clip((px * d[0] + py * d[1]) / den, 0.0, 1.0) if den > 0 \
        else np.zeros_like(px, np.float64)
    dist2 = (px - t * d[0]) ** 2 + (py - t * d[1]) ** 2
    _paint(frame, ys, xs, dist2 <= half_width * half_width, color)


def _draw_disc(frame, c, radius: int, color):
    h, w = frame.shape[:2]
    x0, x1 = max(c[0] - radius, 0), min(c[0] + radius, w - 1)
    y0, y1 = max(c[1] - radius, 0), min(c[1] + radius, h - 1)
    if x0 > x1 or y0 > y1:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    _paint(frame, ys, xs,
           (xs - c[0]) ** 2 + (ys - c[1]) ** 2 <= radius * radius, color)


def draw_pose(frame: np.ndarray, keypoints: np.ndarray, color,
              kp_radius: int = 3, conf_thresh: float = 0.3):
    """Draw one skeleton in place: edges whose two keypoints exceed
    conf_thresh, then the keypoints (integer pixel positions, as the cv2
    drawing the JAX package uses)."""
    color = np.asarray(color, np.uint8)
    for a, b in C.SKELETON_EDGES:
        if keypoints[a, 2] > conf_thresh and keypoints[b, 2] > conf_thresh:
            _draw_segment(frame, (int(keypoints[a, 0]), int(keypoints[a, 1])),
                          (int(keypoints[b, 0]), int(keypoints[b, 1])), color)
    for k in range(C.NUM_KEYPOINTS):
        if keypoints[k, 2] > conf_thresh:
            _draw_disc(frame, (int(keypoints[k, 0]), int(keypoints[k, 1])),
                       kp_radius, color)


def render_frame(poses: np.ndarray, width: int, height: int,
                 background: int = 40, colors=None) -> np.ndarray:
    """Rasterise poses [P, 17, 3] to a BGR uint8 frame. colors: optional
    [P, 3] BGR colours, one per person; by default a fixed palette by
    index."""
    frame = np.full((height, width, 3), background, np.uint8)
    for i, pose in enumerate(poses):
        if colors is not None:
            color = tuple(int(c) for c in colors[i])
        else:
            color = (60 + (60 * i) % 196, 200, 255 - (50 * i) % 200)
        draw_pose(frame, pose, color)
    return frame


def calibration_frames(n: int, size: int, n_persons: int = 6,
                       seed: int = 0) -> np.ndarray:
    """n consecutive frames of a synthetic scene rendered at the model's
    input size, as int8 activation calibration takes them
    (models.quant.calibrate_activations): [n, size, size, 3] float32, RGB,
    scaled to 0..1."""
    scene = SyntheticScene(n_persons, size, size, seed=seed)
    frames = np.stack([render_frame(scene.step(), size, size)
                       for _ in range(n)])
    return np.ascontiguousarray(frames[..., ::-1], np.float32) / \
        np.float32(255.0)


class CrowdedScene:
    """The hard tracking scene of posebyte_tpu/utils/synthetic.py (the
    same poses and active masks for the same seed): crossing trajectories,
    close interactions, staggered entry and exit, the regime of the
    two-tier and lost-recovery machinery (reference:
    gpu_tracker.cu:1276-1436), which SyntheticScene, whose figures never
    overlap, does not reach.

    Every person commutes between waypoints on OPPOSITE sides of the
    frame, all paths routed through a shared central corridor, so
    pairs continually cross at varying depths; when rendered
    (render_frame draws in index order) a crossing is a real partial-
    to-full occlusion of the earlier-drawn figure. With entry_exit,
    each person is only active inside a per-identity frame window
    (walks in from an edge / leaves mid-clip).

    step() returns (poses [P,17,3] f32, active [P] bool): GT for the
    ACTIVE people only; occluded-but-active people stay labeled (a
    detector will miss them — that is the point of the benchmark).
    """

    def __init__(self, n_persons: int = 8, width: int = 1280,
                 height: int = 720, seed: int = 0,
                 scale_range=(80.0, 130.0), speed: float = 5.0,
                 entry_exit: bool = True, clip_len: int = 96):
        self.width, self.height = width, height
        rng = np.random.default_rng(seed)
        self.rng = rng
        P = n_persons
        self.scales = rng.uniform(*scale_range, size=P).astype(np.float32)
        m = float(self.scales.max()) * 0.6 + 8.0
        self.margin = m

        # waypoint pairs on opposite sides, routed through the center
        side = rng.integers(0, 2, P)      # 0: left<->right, 1: top<->bottom
        a = np.empty((P, 2), np.float32)
        b = np.empty((P, 2), np.float32)
        for i in range(P):
            if side[i] == 0:
                a[i] = (m, rng.uniform(m, height - m))
                b[i] = (width - m, rng.uniform(m, height - m))
            else:
                a[i] = (rng.uniform(m, width - m), m)
                b[i] = (rng.uniform(m, width - m), height - m)
        # center routing: waypoint sequence a -> center' -> b -> center'' -> a
        self.waypoints = [a, None, b, None]
        self.center_jitter = rng.uniform(-60, 60, size=(2, P, 2)) \
            .astype(np.float32)
        cx, cy = width / 2.0, height / 2.0
        self.waypoints[1] = (np.asarray([[cx, cy]], np.float32)
                             + self.center_jitter[0])
        self.waypoints[3] = (np.asarray([[cx, cy]], np.float32)
                             + self.center_jitter[1])
        self.wp_idx = rng.integers(0, 4, P)
        self.centers = np.stack([self.waypoints[self.wp_idx[i]][i]
                                 for i in range(P)]).astype(np.float32)
        self.speed = np.float32(speed) * rng.uniform(0.7, 1.3, P) \
            .astype(np.float32)

        # entry/exit windows (staggered thirds of the clip)
        if entry_exit:
            start = rng.integers(0, clip_len // 3, P)
            end = clip_len - rng.integers(0, clip_len // 3, P)
            # at least a third of the population spans the whole clip
            always = rng.permutation(P)[:max(1, P // 3)]
            start[always] = 0
            end[always] = clip_len
            self.window = np.stack([start, end], -1)
        else:
            self.window = np.stack([np.zeros(P, np.int64),
                                    np.full(P, 10 ** 9)], -1)
        self.t = -1

    @property
    def n_persons(self) -> int:
        return len(self.centers)

    def step(self):
        """Advance one frame -> (poses [P,17,3], active [P] bool)."""
        self.t += 1
        P = self.n_persons
        for i in range(P):
            tgt = self.waypoints[self.wp_idx[i]][i]
            d = tgt - self.centers[i]
            dist = float(np.hypot(d[0], d[1]))
            if dist < self.speed[i] * 2.0:
                self.wp_idx[i] = (self.wp_idx[i] + 1) % 4
                tgt = self.waypoints[self.wp_idx[i]][i]
                d = tgt - self.centers[i]
                dist = float(np.hypot(d[0], d[1]))
            if dist > 1e-6:
                self.centers[i] += d / dist * self.speed[i]
        poses = np.ones((P, 17, 3), np.float32)
        poses[:, :, :2] = (self.centers[:, None, :]
                           + POSE_OFFSETS[None] * self.scales[:, None, None])
        active = ((self.t >= self.window[:, 0])
                  & (self.t < self.window[:, 1]))
        return poses, active

    def frames(self, n: int):
        """Yield n (poses, active) GT tuples."""
        for _ in range(n):
            yield self.step()

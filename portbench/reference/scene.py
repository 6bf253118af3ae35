"""A frozen copy of the synthetic scene and its rasteriser: multi-person
poses with bouncing linear motion, drawn as skeletons on a dark BGR
canvas (2-px edges, keypoint discs of radius 3, a colour per person).

The benchmark makes every frame it feeds the program, and every
calibration frame, from this file and a seed, so that a change to the
program's own scene generator cannot change the benchmark's traffic.
tests/test_portbench_scene.py holds it byte-equal to the program's copy.
"""
from __future__ import annotations

import numpy as np

# Human-shaped keypoint offsets, unit scale, COCO keypoint order.
POSE_OFFSETS = np.array([
    (0.0, -0.45), (-0.05, -0.5), (0.05, -0.5), (-0.1, -0.48),
    (0.1, -0.48), (-0.2, -0.3), (0.2, -0.3), (-0.25, -0.1),
    (0.25, -0.1), (-0.25, 0.1), (0.25, 0.1), (-0.15, 0.05),
    (0.15, 0.05), (-0.15, 0.3), (0.15, 0.3), (-0.15, 0.5),
    (0.15, 0.5),
], dtype=np.float32)

SKELETON_EDGES = np.array([
    (0, 1), (0, 2), (1, 3), (2, 4),
    (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),
    (5, 11), (6, 12), (11, 12),
    (11, 13), (13, 15), (12, 14), (14, 16),
    (0, 5), (0, 6),
    (3, 5),
], dtype=np.int32)


class SyntheticScene:
    """n_persons figures on a spread-out grid, each moving at `speed` px a
    frame in a direction drawn from the seed and bouncing off a margin:
    step() gives poses [P, 17, 3] float32 in frame pixels, confidence 1."""

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

    def step(self) -> np.ndarray:
        self.centers += self.vels
        lo = self.margin
        hix, hiy = self.width - self.margin, self.height - self.margin
        bounce_x = (self.centers[:, 0] < lo) | (self.centers[:, 0] > hix)
        bounce_y = (self.centers[:, 1] < lo) | (self.centers[:, 1] > hiy)
        self.vels[bounce_x, 0] *= -1
        self.vels[bounce_y, 1] *= -1
        self.centers[:, 0] = np.clip(self.centers[:, 0], lo, hix)
        self.centers[:, 1] = np.clip(self.centers[:, 1], lo, hiy)
        poses = np.ones((len(self.centers), 17, 3), np.float32)
        poses[:, :, :2] = (self.centers[:, None, :]
                           + POSE_OFFSETS[None] * self.scales[:, None, None])
        return poses


def _draw_segment(frame, a, b, color, half_width: float = 1.5):
    """Pixels whose centre lies within half_width of segment a-b."""
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
    mask = dist2 <= half_width * half_width
    frame[ys[mask], xs[mask]] = color


def _draw_disc(frame, c, radius: int, color):
    h, w = frame.shape[:2]
    x0, x1 = max(c[0] - radius, 0), min(c[0] + radius, w - 1)
    y0, y1 = max(c[1] - radius, 0), min(c[1] + radius, h - 1)
    if x0 > x1 or y0 > y1:
        return
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    mask = (xs - c[0]) ** 2 + (ys - c[1]) ** 2 <= radius * radius
    frame[ys[mask], xs[mask]] = color


def draw_pose(frame: np.ndarray, keypoints: np.ndarray, color,
              kp_radius: int = 3, conf_thresh: float = 0.3):
    """One skeleton in place: the edges whose two keypoints exceed
    conf_thresh, then the keypoints, at integer pixel positions."""
    color = np.asarray(color, np.uint8)
    for a, b in SKELETON_EDGES:
        if keypoints[a, 2] > conf_thresh and keypoints[b, 2] > conf_thresh:
            _draw_segment(frame, (int(keypoints[a, 0]), int(keypoints[a, 1])),
                          (int(keypoints[b, 0]), int(keypoints[b, 1])), color)
    for k in range(17):
        if keypoints[k, 2] > conf_thresh:
            _draw_disc(frame, (int(keypoints[k, 0]), int(keypoints[k, 1])),
                       kp_radius, color)


def render_frame(poses: np.ndarray, width: int, height: int,
                 background: int = 40) -> np.ndarray:
    """Poses [P, 17, 3] -> a BGR uint8 frame [height, width, 3]."""
    frame = np.full((height, width, 3), background, np.uint8)
    for i, pose in enumerate(poses):
        draw_pose(frame, pose, (60 + (60 * i) % 196, 200,
                                255 - (50 * i) % 200))
    return frame


def render_clip(n_frames: int, width: int, height: int, n_persons: int,
                seed: int, scale_range=(90.0, 140.0),
                speed: float = 4.0) -> np.ndarray:
    """n_frames consecutive frames of one scene -> [n_frames, height,
    width, 3] uint8 BGR."""
    scene = SyntheticScene(n_persons, width, height, seed=seed,
                           scale_range=scale_range, speed=speed)
    return np.stack([render_frame(scene.step(), width, height)
                     for _ in range(n_frames)])


def calibration_frames(n: int, size: int, n_persons: int,
                       seed: int) -> np.ndarray:
    """n consecutive frames of a scene drawn at the model's input size, as
    int8 activation calibration takes them: [n, size, size, 3] float32,
    RGB, scaled to 0..1."""
    frames = render_clip(n, size, size, n_persons, seed)
    return np.ascontiguousarray(frames[..., ::-1], np.float32) / \
        np.float32(255.0)

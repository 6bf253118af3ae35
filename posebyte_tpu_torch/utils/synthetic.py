"""Synthetic scenes and a numpy skeleton rasteriser, so that frames with
people in them can be made without cv2.

SyntheticScene is posebyte_tpu/utils/synthetic.py's scene (the same motion
and the same poses for the same seed). render_frame follows its
render_frame/draw_pose (utils/video.py:134-147): skeleton edges as 2-px
lines, keypoints as filled discs of radius 3, per-person colours. It does
not match cv2 pixel for pixel.
"""
from __future__ import annotations

import numpy as np

from ..core import constants as C

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
                 background: int = 40) -> np.ndarray:
    """Rasterise poses [P, 17, 3] to a BGR uint8 frame."""
    frame = np.full((height, width, 3), background, np.uint8)
    for i, pose in enumerate(poses):
        color = (60 + (60 * i) % 196, 200, 255 - (50 * i) % 200)
        draw_pose(frame, pose, color)
    return frame

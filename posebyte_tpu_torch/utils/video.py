"""Video I/O and drawing, after posebyte_tpu/utils/video.py (reference:
src/utils/video_utils.cpp).

VideoReader, PrefetchVideoReader and VideoWriter wrap OpenCV, imported only
inside _cv2() when one of them is used: the rest of the port runs without
cv2, and a host without it (the card's) makes frames in memory and draws
through the native rasteriser (utils/native.py). The drawing uses the
reference's 20-colour palette and 19-edge COCO skeleton
(video_utils.cpp:10-48).
"""
from __future__ import annotations

import numpy as np

from ..core import constants as C

# 20-color track palette, BGR (reference: video_utils.cpp:10-31)
TRACK_COLORS = np.array([
    (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
    (255, 0, 255), (0, 255, 255), (128, 0, 0), (0, 128, 0),
    (0, 0, 128), (128, 128, 0), (128, 0, 128), (0, 128, 128),
    (255, 128, 0), (255, 0, 128), (128, 255, 0), (0, 255, 128),
    (128, 0, 255), (0, 128, 255), (192, 192, 192), (64, 64, 64),
], dtype=np.uint8)


def _cv2():
    try:
        import cv2
        return cv2
    except ImportError as e:   # pragma: no cover
        raise RuntimeError(
            "OpenCV (cv2) is required for video I/O / drawing") from e


class VideoReader:
    """cv2.VideoCapture wrapper (reference: video_utils.cpp:229-257)."""

    def __init__(self, path: str):
        cv2 = _cv2()
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"failed to open video: {path}")
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = float(self.cap.get(cv2.CAP_PROP_FPS)) or 30.0
        self.frame_count = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def read(self):
        ok, frame = self.cap.read()
        return frame if ok else None

    def __iter__(self):
        while True:
            f = self.read()
            if f is None:
                return
            yield f

    def release(self):
        self.cap.release()


class PrefetchVideoReader(VideoReader):
    """VideoReader with a background decode thread + bounded queue.

    cv2 releases the GIL during decode, so a single prefetch thread
    overlaps video decoding with the TPU dispatch loop — the host-side
    analogue of the reference's stream overlap (main.cpp's loop decodes
    on the critical path; here decode of frame N+1 hides behind frame
    N's tracking). Bounded queue applies backpressure; iteration order
    and termination semantics are identical to VideoReader.
    """

    def __init__(self, path: str, depth: int = 8):
        super().__init__(path)
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = False
        self._stop = False

        def worker():
            while not self._stop:
                f = super(PrefetchVideoReader, self).read()
                self._q.put(f)
                if f is None:
                    return

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def read(self):
        if self._done:
            return None
        f = self._q.get()
        if f is None:
            self._done = True
        return f

    def release(self):
        # signal the worker to stop, then empty the queue WITHOUT
        # decoding the remaining frames (early exit on a long video must
        # not block for the full remaining decode time)
        self._stop = True
        self._done = True
        import queue
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=2.0)
        super().release()


class VideoWriter:
    """cv2.VideoWriter wrapper (reference: video_utils.cpp:259-278)."""

    def __init__(self, path: str, width: int, height: int,
                 fps: float = 30.0):
        cv2 = _cv2()
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
        self.writer = cv2.VideoWriter(path, fourcc, fps, (width, height))
        if not self.writer.isOpened():
            raise IOError(f"failed to create output video: {path}")

    def write(self, frame: np.ndarray):
        self.writer.write(frame)

    def release(self):
        self.writer.release()


def draw_pose(frame: np.ndarray, keypoints: np.ndarray, color,
              kp_radius: int = 3, conf_thresh: float = 0.3):
    """Draw one skeleton (reference: drawPose, video_utils.cpp:50-102)."""
    cv2 = _cv2()
    color = tuple(int(c) for c in color)
    for a, b in C.SKELETON_EDGES:
        if keypoints[a, 2] > conf_thresh and keypoints[b, 2] > conf_thresh:
            pa = (int(keypoints[a, 0]), int(keypoints[a, 1]))
            pb = (int(keypoints[b, 0]), int(keypoints[b, 1]))
            cv2.line(frame, pa, pb, color, 2)
    for k in range(C.NUM_KEYPOINTS):
        if keypoints[k, 2] > conf_thresh:
            cv2.circle(frame, (int(keypoints[k, 0]), int(keypoints[k, 1])),
                       kp_radius, color, -1)


def draw_all_tracks(frame: np.ndarray, tracks, conf_thresh: float = 0.3,
                    use_native: bool = True):
    """Draw every track with its id-keyed colour and label, in place
    (reference: drawAllTracks, video_utils.cpp:134-193).

    Prefers the native rasteriser (utils/native.py, one call for the whole
    frame); without it, or with use_native=False, draws each primitive
    with cv2."""
    if use_native:
        from . import native
        if native.available():
            return native.draw_tracks_native(frame, tracks, TRACK_COLORS,
                                             conf_thresh)
    cv2 = _cv2()
    for t in tracks:
        color = TRACK_COLORS[t.track_id % len(TRACK_COLORS)]
        draw_pose(frame, t.keypoints, color, conf_thresh=conf_thresh)
        x1, y1 = int(t.bbox[0]), int(t.bbox[1])
        x2, y2 = int(t.bbox[2]), int(t.bbox[3])
        c = tuple(int(v) for v in color)
        cv2.rectangle(frame, (x1, y1), (x2, y2), c, 2)
        label = f"ID:{t.track_id} {t.score:.2f}"
        cv2.putText(frame, label, (x1, max(y1 - 5, 12)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, c, 2)
    return frame


def draw_stats(frame: np.ndarray, fps: float, num_tracks: int,
               inference_ms: float, use_native: bool = True):
    """FPS / track-count / latency overlay, in place (reference: drawStats,
    video_utils.cpp:195-223).

    Prefers the native rasteriser, whose 5x7 font has digits, ':', '.',
    '-' and the capitals of "FPS", "TRACKS" and "MS" (so it writes the
    latency line as "MS: 1.23"), each line black and then green one pixel
    up and left, at twice the font's size; a host without cv2 (the card's)
    draws this way. Without it, or with use_native=False, the JAX package's
    cv2 text."""
    if use_native:
        from . import native
        lib = native.load()
        if lib is not None:
            if not frame.flags.c_contiguous:
                raise ValueError("draw_stats draws in place: the frame must "
                                 "be C-contiguous")
            h, w = frame.shape[:2]
            lines = [f"FPS: {fps:.1f}", f"TRACKS: {num_tracks}",
                     f"MS: {inference_ms:.2f}"]
            black = np.zeros(3, np.uint8)
            green = np.array([0, 255, 0], np.uint8)
            for i, line in enumerate(lines):
                y = 10 + 28 * i
                lib.pb_draw_text(frame, w, h, 11, y + 1, line.encode(),
                                 black, 2)
                lib.pb_draw_text(frame, w, h, 10, y, line.encode(), green, 2)
            return frame
    cv2 = _cv2()
    lines = [f"FPS: {fps:.1f}", f"Tracks: {num_tracks}",
             f"Inference: {inference_ms:.2f} ms"]
    y = 25
    for line in lines:
        cv2.putText(frame, line, (10, y), cv2.FONT_HERSHEY_SIMPLEX,
                    0.7, (0, 0, 0), 4)
        cv2.putText(frame, line, (10, y), cv2.FONT_HERSHEY_SIMPLEX,
                    0.7, (0, 255, 0), 2)
        y += 28
    return frame

"""ctypes bindings for the port's native host runtime
(csrc/host/posebyte_native.cpp), after posebyte_tpu/utils/native.py:
drawing without cv2 (skeletons, boxes, 5x7-font labels) and the CPU
letterbox reference.

The library is built with one g++ call on first use (never on import) into
build/native/ at the repository root, under a hash of the source, the flags
and the host's CPU (the flags include -march=native), and loaded from
there; a build writes to a temporary file and renames it into place, so
processes building at once never load a half-written library.
POSEBYTE_NATIVE_BUILD_DIR overrides the directory. load() returns None when
no library can be built, and utils.video.draw_all_tracks then draws with
cv2, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile

import numpy as np

from ..core import constants as C

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host", "posebyte_native.cpp")
# native/build.sh's flags: the same code as the JAX package's library.
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_lib = None


def build_dir() -> str:
    return os.environ.get("POSEBYTE_NATIVE_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "native")


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")),
                        "")
    except OSError:
        return ""


def library_path() -> str:
    """Path of the library for this source, these flags and this CPU."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update((platform.machine() + _cpu_model()).encode())
    return os.path.join(build_dir(),
                        f"libposebyte_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Build the library unless it is current; returns its path. Raises
    RuntimeError with g++'s output when the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(build_dir(), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
    os.close(fd)
    try:
        r = subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load(auto_build: bool = True):
    """The loaded library (built first if needed and auto_build); None when
    it cannot be built or is missing."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path) and auto_build:
        try:
            build()
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    ci = ctypes.c_int
    lib.pb_draw_pose.argtypes = [u8p, ci, ci, f32p, i32p, ci, u8p,
                                 ctypes.c_float, ci, ci]
    lib.pb_draw_tracks.argtypes = [u8p, ci, ci, f32p, ci, i32p, ci, u8p,
                                   ci, ctypes.c_float]
    lib.pb_draw_text.argtypes = [u8p, ci, ci, ci, ci, ctypes.c_char_p,
                                 u8p, ci]
    lib.pb_letterbox_cpu.argtypes = [u8p, ci, ci, f32p, ci, ci]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


_EDGES = np.ascontiguousarray(C.SKELETON_EDGES.astype(np.int32))


def draw_tracks_native(frame: np.ndarray, tracks, palette: np.ndarray,
                       conf_thresh: float = 0.3):
    """Draw a list of TrackOutput onto a C-contiguous uint8 HWC frame, in
    place, in one native call (the fast path of
    utils.video.draw_all_tracks)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = len(tracks)
    if n == 0:
        return frame
    if not frame.flags.c_contiguous:
        raise ValueError("draw_tracks_native draws in place: the frame "
                         "must be C-contiguous")
    packed = np.zeros((n, 57), np.float32)
    for i, t in enumerate(tracks):
        packed[i, 0] = t.track_id
        packed[i, 1] = t.score
        packed[i, 2:6] = t.bbox
        packed[i, 6:] = np.asarray(t.keypoints, np.float32).reshape(-1)
    pal = np.ascontiguousarray(palette.astype(np.uint8))
    h, w = frame.shape[:2]
    lib.pb_draw_tracks(frame, w, h, packed, n, _EDGES, len(_EDGES), pal,
                       len(pal), ctypes.c_float(conf_thresh))
    return frame


def letterbox_cpu(image: np.ndarray, target: int = 640,
                  bgr_to_rgb: bool = True) -> np.ndarray:
    """CPU letterbox reference in native code -> float32 [3, target,
    target] in 0..1 (the reference's CPU preprocess,
    yolo_pose_engine.cpp:515-557)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    h, w = image.shape[:2]
    out = np.empty((3, target, target), np.float32)
    lib.pb_letterbox_cpu(np.ascontiguousarray(image), w, h, out, target,
                         1 if bgr_to_rgb else 0)
    return out

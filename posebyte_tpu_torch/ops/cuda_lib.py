"""Build and load the port's CUDA kernels (posebyte_tpu_torch/csrc/).

One nvcc call compiles every source into one shared library with a plain C
interface, loaded with ctypes; no PyTorch header is compiled. The library
is cached in build/cuda/ at the repository root under a hash of the sources
and flags, so the first use on a machine builds it and later uses load it.
A build writes to a temporary file and renames it into place, so processes
building at once never load a half-written library. Nothing here runs at
import time.

Environment: CUDA_HOME (default /usr/local/cuda) locates nvcc, else the
PATH does; POSEBYTE_CUDA_BUILD_DIR overrides the build directory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("nms_keep.cu", "auction.cu")
HEADERS = ("auction.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: (restype, argtypes)
    "posebyte_nms_keep": (_c_int, [_c_void_p, _c_void_p, _c_void_p,
                                   _c_void_p, _c_int, _c_int, _c_float,
                                   _c_float, _c_void_p, _c_void_p]),
    "posebyte_nms_keep_max_n": (_c_int, []),
    "posebyte_auction": (_c_int, [_c_void_p, _c_void_p, _c_void_p,
                                  _c_void_p, _c_int, _c_int, _c_int, _c_int,
                                  _c_float, _c_void_p]),
    "posebyte_auction_smem_bytes": (ctypes.c_size_t, [_c_int, _c_int]),
    "posebyte_error_string": (ctypes.c_char_p, [_c_int]),
}

# The loaded library, one per process (a ctypes handle cannot be unloaded).
_lib = None


def build_dir() -> str:
    return os.environ.get("POSEBYTE_CUDA_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG), "build", "cuda")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else (shutil.which("nvcc") or path)


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(),
                        f"libposebyte_cuda_{h.hexdigest()[:16]}.so")


def build() -> tuple[str, float]:
    """Build the library unless the cached one is current.

    Returns (path, seconds spent building; 0.0 when cached). Raises
    RuntimeError with nvcc's output when the build fails."""
    path = library_path()
    if os.path.exists(path):
        return path, 0.0
    os.makedirs(build_dir(), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path, time.perf_counter() - t0


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if status != 0:
        msg = load().posebyte_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")

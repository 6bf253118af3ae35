"""Build and load the port's CUDA kernels (posebyte_tpu_torch/csrc/).

One nvcc process per source, all started together, compiles the sources,
and one more links them into a shared library with a plain C interface,
loaded with ctypes; no PyTorch header is compiled. The library is cached
in build/cuda/ at the repository root under a hash of the sources and
flags, so the first use on a machine builds it and later uses load it. A
build writes to a temporary directory and renames the library into place,
so processes building at once never load a half-written library; nvcc's
report of each kernel's registers and spills (-Xptxas -v) is kept beside
the library (ptxas_usage reads it). Nothing here runs at import time.

Environment: CUDA_HOME (default /usr/local/cuda) locates nvcc, else the
PATH does; POSEBYTE_CUDA_BUILD_DIR overrides the build directory.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("nms_keep.cu", "auction.cu", "tracker_chunk.cu",
           "conv_int8.cu")
HEADERS = ("auction.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # name: (restype, argtypes)
    "posebyte_nms_keep": (_c_int, [_c_void_p, _c_void_p, _c_void_p,
                                   _c_void_p, _c_void_p, _c_int, _c_int,
                                   _c_float, _c_float, _c_void_p,
                                   _c_void_p]),
    "posebyte_auction": (_c_int, [_c_void_p, _c_void_p, _c_void_p,
                                  _c_void_p, _c_int, _c_int, _c_int, _c_int,
                                  _c_float, _c_void_p, _c_void_p]),
    "posebyte_auction_smem_bytes": (ctypes.c_size_t, [_c_int, _c_int]),
    "posebyte_tracker_chunk": (_c_int, [_c_void_p, _c_void_p, _c_void_p,
                                        _c_void_p]),
    "posebyte_tracker_chunk_smem_bytes": (ctypes.c_size_t,
                                          [_c_int, _c_int, _c_int]),
    "posebyte_conv_int8": (_c_int, [_c_void_p, _c_int, _c_void_p, _c_int,
                                    _c_int] + [_c_void_p] * 4 + [_c_int] * 10
                           + [_c_void_p]),
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
    tmp = tempfile.mkdtemp(dir=build_dir())
    t0 = time.perf_counter()
    objs, procs = [], []
    try:
        for name in SOURCES:
            objs.append(os.path.join(tmp, name + ".o"))
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", os.path.join(CSRC, name),
                   "-o", objs[-1]]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for cmd, proc in procs:
            out, _ = proc.communicate(timeout=600)
            log.append(out)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        lib = os.path.join(tmp, "lib.so")
        cmd = [_nvcc(), "-shared", "-o", lib, *objs]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n"
                               f"{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
        with open(_log_path(path), "w") as f:
            f.write("".join(log))
        os.replace(lib, path)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return path, time.perf_counter() - t0


def _log_path(path: str) -> str:
    return path[:-len(".so")] + ".ptxas.txt"


def ptxas_usage() -> dict:
    """{kernel's mangled name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from the -Xptxas -v report of the current library's
    build (built first if needed)."""
    path, _ = build()
    with open(_log_path(path)) as f:
        log = f.read()
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            usage[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def bind(path: str):
    """The library at `path`, loaded, with the C entries it has given their
    signatures (a variant built from one source has only its own)."""
    lib = ctypes.CDLL(path)
    for name, (restype, argtypes) in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    return lib


def load():
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        _lib = bind(build()[0])
    return _lib


def use(lib) -> None:
    """Make `lib` (from bind) the library every wrapper launches: how
    utils.kernel_variants times a source variant through the wrappers."""
    global _lib
    _lib = lib


def check(status: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if status != 0:
        msg = load().posebyte_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")

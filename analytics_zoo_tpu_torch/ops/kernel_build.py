"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use (``InferenceModel.prewarm`` triggers it before traffic),
never at import, and lands in ``build/analytics_zoo_tpu_torch/`` beside the
package. The library's file name carries a hash of the sources and flags, so
a second process or run reuses it; a build writes a temporary file and
renames it into place, so two processes building at once never tear it.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
import uuid
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "analytics_zoo_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last ``load_library`` call spent building (0.0 = reused)
last_build_seconds = 0.0


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs, hdrs


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def library_path() -> str:
    """Where the library for the current sources lives (built or not)."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs + hdrs:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libazt_kernels-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    srcs, _ = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = os.path.join(BUILD_DIR, f".{uuid.uuid4().hex}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, *srcs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a tear
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.azt_gather_rows.argtypes = [p, p, p, ll, ll, ll, i, i, p]
    lib.azt_gather_rows.restype = i
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first use."""
    global _lib, last_build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = library_path()
            t0 = time.perf_counter()
            if not os.path.exists(path):
                _build(path)
            last_build_seconds = time.perf_counter() - t0
            _lib = _bind(ctypes.CDLL(path))
    return _lib

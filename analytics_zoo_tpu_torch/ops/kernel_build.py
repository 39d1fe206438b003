"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``,
all of them started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build
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

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "analytics_zoo_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

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


def _run_all(cmds) -> None:
    """Start every ``nvcc`` command at once, wait for all, raise if any
    failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(out: str) -> None:
    srcs, _ = _sources()
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.join(BUILD_DIR, f".{uuid.uuid4().hex}")
    objs = [f"{stem}.{os.path.basename(src)}.o" for src in srcs]
    tmp = f"{stem}.tmp.so"
    nvcc = [_nvcc(), *NVCC_FLAGS]
    try:
        # one nvcc per source, all started together, then one link
        _run_all([[*nvcc, "-I", CSRC_DIR, "-c", "-o", obj, src]
                  for src, obj in zip(srcs, objs)])
        _run_all([[*nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, out)  # atomic: a concurrent loader never sees a tear
    finally:
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.remove(path)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.azt_gather_rows.argtypes = [p, p, p, ll, ll, ll, i, i, p]
    lib.azt_gather_rows.restype = i
    lib.azt_gather_pool.argtypes = [p, p, p, ll, i, ll, ll, i, i, i, p]
    lib.azt_gather_pool.restype = i
    lib.azt_gather_int8.argtypes = [p, p, p, p, ll, ll, ll, p]
    lib.azt_gather_int8.restype = i
    lib.azt_scatter_rows.argtypes = [p, p, p, ll, ll, ll, p]
    lib.azt_scatter_rows.restype = i
    f, u = ctypes.c_float, ctypes.c_uint32
    lib.azt_fused_short_fwd_f32.argtypes = [p] * 7 + [ll, i, i, i, f, u, f,
                                                      i, p]
    lib.azt_fused_short_fwd_f32.restype = i
    lib.azt_fused_short_bwd_f32.argtypes = [p] * 12 + [ll, i, i, i, f, f, u,
                                                       f, i, p]
    lib.azt_fused_short_bwd_f32.restype = i
    lib.azt_fused_short_fwd_bf16.argtypes = [p] * 7 + [ll, i, i, i, f, u, f,
                                                       i, p]
    lib.azt_fused_short_fwd_bf16.restype = i
    lib.azt_fused_short_bwd_bf16.argtypes = [p] * 11 + [ll, i, i, i, f, f,
                                                        u, f, i, p]
    lib.azt_fused_short_bwd_bf16.restype = i
    lib.azt_flash_fwd.argtypes = [p] * 6 + [ll, i, i, i, i, f, i, p]
    lib.azt_flash_fwd.restype = i
    lib.azt_flash_bwd_dq.argtypes = [p] * 8 + [ll, i, i, i, f, f, i, p]
    lib.azt_flash_bwd_dq.restype = i
    lib.azt_flash_bwd_dkv.argtypes = [p] * 9 + [ll, i, i, i, f, f, i, p]
    lib.azt_flash_bwd_dkv.restype = i
    lib.azt_flash_bwd_fused.argtypes = [p] * 10 + [ll, i, i, i, f, f, i, p]
    lib.azt_flash_bwd_fused.restype = i
    lib.azt_flash_fwd_bf16.argtypes = [p] * 6 + [ll, i, i, i, i, f, i, p]
    lib.azt_flash_fwd_bf16.restype = i
    lib.azt_flash_bwd_fused_bf16.argtypes = [p] * 10 + [ll, i, i, i, f, f,
                                                        i, p]
    lib.azt_flash_bwd_fused_bf16.restype = i
    lib.azt_flash_bwd_dq_bf16.argtypes = [p] * 8 + [ll, i, i, i, f, f, i, p]
    lib.azt_flash_bwd_dq_bf16.restype = i
    lib.azt_flash_bwd_dkv_bf16.argtypes = [p] * 9 + [ll, i, i, i, f, f, i,
                                                     p]
    lib.azt_flash_bwd_dkv_bf16.restype = i
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


class LaunchCounts(dict):
    """Kernel launches per wrapper, ``{name: count}``, counted where a
    wrapper launches its kernel and nowhere else (``chip_smoke.py`` reads
    them to prove a path ran the kernels)."""

    def __init__(self, *names: str):
        super().__init__({n: 0 for n in names})
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            for k in self:
                self[k] = 0

    def launched(self, name: str, rc: int) -> None:
        """Raise if the C entry point returned a CUDA error, else count."""
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{rc}")
        with self._lock:
            self[name] += 1


def on_card(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no {name} for device {t.device}")
    return True

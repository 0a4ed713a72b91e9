"""Build and load the hand-written CUDA kernels (``csrc/``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, under ``build/`` next to the
package; the file name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library. The library is bound
with ``ctypes``: pointers and the stream go as ``c_void_p``. A missing
compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""        # the compiler's output of the last build (ptxas -v)
build_seconds = 0.0   # 0.0 when the library was already built


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the grid kernels "
                       "are built from source at first use")


def _bind(lib):
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.rig_linearize.argtypes = ([i, i, i] + [p] * 5 + [i] * 8 + [d, i]
                                  + [p] * 5)
    lib.rig_cost.argtypes = [i, i] + [p] * 4 + [i] * 5 + [d, i, i, p, p]
    lib.rig_reduce_slots.argtypes = [i, p] + [i] * 5 + [p, p, p]
    lib.rig_reduce_cost.argtypes = [i, p, i, p, p]
    for fn in (lib.rig_linearize, lib.rig_cost, lib.rig_reduce_slots,
               lib.rig_reduce_cost):
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library, built first if needed."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    srcs = sorted(f for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    so = os.path.join(BUILD_DIR, f"librig_grid_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                        os.path.join(CSRC, "rig_grid.cu")]
        t0 = time.time()
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.time() - t0
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, so)
    _lib = _bind(ctypes.CDLL(so))
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a launcher's non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")

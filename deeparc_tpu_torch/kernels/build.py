"""Build and load the hand-written CUDA kernels (``csrc/``).

Every ``.cu`` under ``csrc/`` is compiled with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, at first use, under ``build/`` next to
the package; the file name carries a hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the library. The library is
bound with ``ctypes``: pointers and the stream go as ``c_void_p``. A
missing compiler or a failed build raises.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""        # the compiler's output of the last build (ptxas -v)
build_seconds = 0.0   # 0.0 when the library was already built


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the kernels are "
                       "built from source at first use")


def _bind(lib):
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    sigs = {
        "rig_linearize": [i, i, i] + [p] * 5 + [i] * 8 + [d, i] + [p] * 5,
        "rig_linearize_mono_grid": [i] * 4,
        "rig_linearize_mono": [i, i] + [p] * 4 + [i] * 5 + [d, i] + [p] * 5,
        "rig_linearize_band_grid": [i] * 5,
        "rig_linearize_band": [i] * 3 + [p] * 5 + [i] * 8 + [d, i] + [p] * 5,
        "tile_sort_planes": [i, p, p, i, i, i, p, p],
        "tile_lsweep": [i] * 3 + [p] * 10 + [i] * 4 + [p] * 3,
        "tile_gather_cells": [i, p, p, p, i, i, p, p],
        "probe_fma_pass": [i, p, ctypes.c_long, p, p],
        "probe_sweep_payload": [i, p, p, i, p, p],
        "rig_cost_band": [i, i] + [p] * 4 + [i, i, d, p, p, p],
        "rig_reduce_slots": [i, p] + [i] * 5 + [p, p, p],
        "rig_reduce_cost": [i, p, i, p, p],
        "rig_schur_setup": [i],
        "rig_schur_reduce": [i, p, p, p, i, i, i] + [p] * 5,
        "tile_linearize_rows": [i, i, i] + [p] * 6 + [i] * 4 + [d, i, i]
                               + [p] * 6,
        "tile_linearize_bins": [i, i] + [p] * 10 + [i] * 4 + [d, p, p, p],
        "tile_edot": [i] * 3 + [p] * 4 + [i] * 5 + [p, p],
        "tile_gsweep": [i] * 3 + [p] * 9 + [i] * 4 + [p] * 3,
        "tile_sort_jcam": [i, i, p, p, i, i, p, p],
        "tile_reduce_bins": [i, p, p, i, i, p, p],
        "tile_reduce_cost": [i, p, i, p, p],
        "gl_while_begin": [p] * 5,
        "gl_set_condition": [p, ctypes.c_ulonglong, p],
        "gl_while_end": [p],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _run_all(cmds):
    """Start every command, wait for all; (returncodes, joined output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], "".join(outs)


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
    so = os.path.join(BUILD_DIR, f"libdeeparc_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{os.getpid()}.tmp"
        objs = [os.path.join(BUILD_DIR, f"{f}.{tag}.o")
                for f in srcs if f.endswith(".cu")]
        t0 = time.time()
        rcs, build_log = _run_all([
            [nvcc] + NVCC_FLAGS + ["-c", "-o", o, os.path.join(CSRC, f)]
            for f, o in zip((f for f in srcs if f.endswith(".cu")), objs)])
        if any(rcs):
            raise RuntimeError(f"nvcc failed ({rcs}):\n{build_log}")
        tmp = f"{so}.{tag}"
        rcs, link_log = _run_all([[nvcc, "-shared", "-o", tmp] + objs])
        build_log += link_log
        build_seconds = time.time() - t0
        if any(rcs):
            raise RuntimeError(f"nvcc link failed ({rcs}):\n{build_log}")
        os.replace(tmp, so)
        for o in objs:
            os.remove(o)
    _lib = _bind(ctypes.CDLL(so))
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a launcher's non-zero cudaError_t."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")

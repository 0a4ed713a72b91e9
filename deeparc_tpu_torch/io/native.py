"""ctypes binding to the native (C++) .deeparc / BAL parsers.

The native data-loader component (native/deeparc_io.cc): a single-pass
strtod tokenizer replacing the reference's iostream extraction loop
(``src/DeepArcManager.cc:26-164``). Builds on first use with g++ (cached
.so); every entry point falls back to the pure-numpy parsers in
deeparc_format.py / bal.py when the toolchain is unavailable, so the
framework never hard-depends on the native path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from deeparc_tpu_torch.io.deeparc_format import (
    DeepArcData,
    _np_matrix_to_angle_axis,
    _np_quaternion_to_angle_axis,
)

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
# Search order: package-local _native/ (wheel installs, see pyproject
# [tool.setuptools.package-data]) then the in-repo native/build (editable
# installs / source checkouts, where build.sh can rebuild on demand).
_PKG_SO_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "_native", "libdeeparc_io.so",
)
_SO_PATH = (
    _PKG_SO_PATH if os.path.exists(_PKG_SO_PATH)
    else os.path.join(_NATIVE_DIR, "build", "libdeeparc_io.so")
)
_lib = None
_build_failed = False


class _DeepArcParsed(ctypes.Structure):
    _fields_ = [
        ("ok", ctypes.c_int32),
        ("version", ctypes.c_double),
        ("n_obs", ctypes.c_int32), ("n_intrinsic", ctypes.c_int32),
        ("n_arc", ctypes.c_int32), ("n_ring", ctypes.c_int32),
        ("n_point", ctypes.c_int32), ("n_extrinsic", ctypes.c_int32),
        ("share_extrinsic", ctypes.c_int32),
        ("obs_arc", ctypes.POINTER(ctypes.c_int32)),
        ("obs_ring", ctypes.POINTER(ctypes.c_int32)),
        ("obs_point", ctypes.POINTER(ctypes.c_int32)),
        ("obs_xy", ctypes.POINTER(ctypes.c_double)),
        ("center", ctypes.POINTER(ctypes.c_double)),
        ("focal", ctypes.POINTER(ctypes.c_double)),
        ("focal_size", ctypes.POINTER(ctypes.c_int32)),
        ("dist", ctypes.POINTER(ctypes.c_double)),
        ("dist_size", ctypes.POINTER(ctypes.c_int32)),
        ("ext_trans", ctypes.POINTER(ctypes.c_double)),
        ("ext_rot_raw", ctypes.POINTER(ctypes.c_double)),
        ("ext_rot_size", ctypes.POINTER(ctypes.c_int32)),
        ("points", ctypes.POINTER(ctypes.c_double)),
        ("colors", ctypes.POINTER(ctypes.c_int32)),
        ("error", ctypes.c_char * 256),
    ]


class _BalParsed(ctypes.Structure):
    _fields_ = [
        ("ok", ctypes.c_int32),
        ("n_cameras", ctypes.c_int32), ("n_points", ctypes.c_int32),
        ("n_obs", ctypes.c_int32),
        ("obs_cam", ctypes.POINTER(ctypes.c_int32)),
        ("obs_point", ctypes.POINTER(ctypes.c_int32)),
        ("obs_xy", ctypes.POINTER(ctypes.c_double)),
        ("cameras", ctypes.POINTER(ctypes.c_double)),
        ("points", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char * 256),
    ]


def _load_library():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    if not os.path.exists(_SO_PATH):
        try:
            subprocess.run(
                ["sh", os.path.join(_NATIVE_DIR, "build.sh")],
                check=True, capture_output=True, timeout=120,
            )
        except Exception:
            _build_failed = True
            return None
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError:
        _build_failed = True
        return None
    lib.deeparc_parse.restype = ctypes.POINTER(_DeepArcParsed)
    lib.deeparc_parse.argtypes = [ctypes.c_char_p]
    lib.deeparc_free.argtypes = [ctypes.POINTER(_DeepArcParsed)]
    lib.bal_parse.restype = ctypes.POINTER(_BalParsed)
    lib.bal_parse.argtypes = [ctypes.c_char_p]
    lib.bal_free.argtypes = [ctypes.POINTER(_BalParsed)]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_library() is not None


def _copy(ptr, shape, dtype):
    n = int(np.prod(shape))
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)
    return arr.reshape(shape)


def read_deeparc_native(path: str) -> DeepArcData:
    """Parse with the native tokenizer; raises if the library is missing
    (callers that want graceful fallback use ``read_deeparc_fast``)."""
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    handle = lib.deeparc_parse(path.encode())
    try:
        p = handle.contents
        if not p.ok:
            raise ValueError(f"{path}: {p.error.decode()}")
        n_ext = p.n_extrinsic
        rot_raw = _copy(p.ext_rot_raw, (n_ext, 9), np.float64)
        rot_size = _copy(p.ext_rot_size, (n_ext,), np.int32)
        ext_rot = np.zeros((n_ext, 3))
        for i in range(n_ext):
            if rot_size[i] == 3:
                ext_rot[i] = rot_raw[i, :3]
            elif rot_size[i] == 4:
                ext_rot[i] = _np_quaternion_to_angle_axis(rot_raw[i, :4])
            else:
                ext_rot[i] = _np_matrix_to_angle_axis(rot_raw[i])
        return DeepArcData(
            version=p.version,
            share_extrinsic=bool(p.share_extrinsic),
            arc_size=p.n_arc, ring_size=p.n_ring,
            obs_arc=_copy(p.obs_arc, (p.n_obs,), np.int32),
            obs_ring=_copy(p.obs_ring, (p.n_obs,), np.int32),
            obs_point=_copy(p.obs_point, (p.n_obs,), np.int32),
            obs_xy=_copy(p.obs_xy, (p.n_obs, 2), np.float64),
            center=_copy(p.center, (p.n_intrinsic, 2), np.float64),
            focal=_copy(p.focal, (p.n_intrinsic, 2), np.float64),
            focal_size=_copy(p.focal_size, (p.n_intrinsic,), np.int32),
            dist=_copy(p.dist, (p.n_intrinsic, 2), np.float64),
            dist_size=_copy(p.dist_size, (p.n_intrinsic,), np.int32),
            ext_rot=ext_rot,
            ext_trans=_copy(p.ext_trans, (n_ext, 3), np.float64),
            points=_copy(p.points, (p.n_point, 3), np.float64),
            colors=_copy(p.colors, (p.n_point, 3), np.int32),
        )
    finally:
        lib.deeparc_free(handle)


def read_bal_native(path: str) -> DeepArcData:
    """Parse a BAL problem with the native tokenizer (same scene mapping and
    focal sign fold as io.bal.read_bal)."""
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native IO library unavailable")
    handle = lib.bal_parse(path.encode())
    try:
        p = handle.contents
        if not p.ok:
            raise ValueError(f"{path}: {p.error.decode()}")
        cam = _copy(p.cameras, (p.n_cameras, 9), np.float64)
        focal = np.zeros((p.n_cameras, 2))
        focal[:, 0] = -cam[:, 6]
        obs_cam = _copy(p.obs_cam, (p.n_obs,), np.int32)
        return DeepArcData(
            version=0.01, share_extrinsic=False,
            arc_size=p.n_cameras, ring_size=0,
            obs_arc=obs_cam, obs_ring=obs_cam.copy(),
            obs_point=_copy(p.obs_point, (p.n_obs,), np.int32),
            obs_xy=_copy(p.obs_xy, (p.n_obs, 2), np.float64),
            center=np.zeros((p.n_cameras, 2)), focal=focal,
            focal_size=np.ones(p.n_cameras, dtype=np.int32),
            dist=np.ascontiguousarray(cam[:, 7:9]),
            dist_size=np.full(p.n_cameras, 2, dtype=np.int32),
            ext_rot=np.ascontiguousarray(cam[:, 0:3]),
            ext_trans=np.ascontiguousarray(cam[:, 3:6]),
            points=_copy(p.points, (p.n_points, 3), np.float64),
            colors=np.full((p.n_points, 3), 255, dtype=np.int32),
        )
    finally:
        lib.bal_free(handle)


def read_deeparc_fast(path: str, **kwargs) -> DeepArcData:
    """Native parse with transparent numpy fallback."""
    if native_available() and not kwargs:
        return read_deeparc_native(path)
    from deeparc_tpu_torch.io.deeparc_format import read_deeparc

    return read_deeparc(path, **kwargs)


def read_bal_fast(path: str) -> DeepArcData:
    if native_available() and not path.endswith(".gz"):
        return read_bal_native(path)
    from deeparc_tpu_torch.io.bal import read_bal

    return read_bal(path)

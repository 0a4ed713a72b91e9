"""The card's published peaks and the least work of a pass over the
observations, counted from the problem's sizes, never from a layout.

One linearize must read each input once: a live observation's pixel (two
float64) and its camera's id (int32), every point, the camera tables; and
write each output the Schur step needs once: per point its gradient (3)
and the unique entries of its 3x3 Gram (6), per distinct (point, free
camera column) pair its E entries (3), per free camera column its
gradient, per cell (distinct extrinsic / intrinsic triple) the unique
entries of its Gram over its free columns. Its operations: per live
observation the unique entries of the Gram of its [point | free camera]
Jacobian rows, two rows of one multiply-add each. One trial cost reads the
same inputs and writes one scalar; its operations, 60 a live observation
(two Rodrigues rotations, the division, the distortion), are far below its
bytes' time.
"""

from __future__ import annotations

import numpy as np

# NVIDIA's data sheet, H100 SXM, at its full 700 W limit: the memory rate
# and the float64 peak (tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_F64 = 67e12
F64, I32 = 8, 4


def least_seconds(nbytes: float, ops: float) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the float64 peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS_F64)


def pass_work(data, ext_free_rows: np.ndarray, intr_free: np.ndarray):
    """{"linearize": (bytes, ops), "cost": (bytes, ops)} of one pass over
    every observation of ``data``, for the extrinsic rows marked free in
    ``ext_free_rows`` (E + 1,) and the intrinsic columns in ``intr_free``
    (K, 6)."""
    from portbench.reference import wiring

    outer, inner, intr = wiring(data)
    M, N = data.n_obs, data.n_points
    E1, K = data.ext_rot.shape[0] + 1, data.center.shape[0]
    k_intr = intr_free.sum(axis=1).astype(np.int64)
    k_obs = (6 * ext_free_rows[outer] + 6 * ext_free_rows[inner]
             + k_intr[intr]).astype(np.int64)
    tables = (E1 * 6 + K * 6) * F64
    read = M * (2 * F64 + I32) + N * 3 * F64 + tables
    # distinct (point, free extrinsic row) and (point, intrinsic) pairs
    pt = data.obs_point.astype(np.int64)
    rows = [pt[ext_free_rows[o] > 0] * E1 + o[ext_free_rows[o] > 0]
            for o in (outer, inner)]
    e_cols = 6 * np.unique(np.concatenate(rows)).size
    ik = k_intr[intr] > 0
    e_cols += int((k_intr[np.unique(pt[ik] * K + intr[ik]) % K]).sum())
    cells = np.unique((outer * E1 + inner) * K + intr)
    k_cell = (6 * ext_free_rows[cells // K // E1]
              + 6 * ext_free_rows[cells // K % E1] + k_intr[cells % K])
    n_free = 6 * int(ext_free_rows.sum()) + int(intr_free.sum())
    written = (N * 9 + 3 * e_cols + n_free
               + int((k_cell * (k_cell + 1) // 2).sum())) * F64
    q = 3 + k_obs
    lin_ops = float((2 * 2 * q * (q + 1) // 2).sum())
    return {"linearize": (float(read + written), lin_ops),
            "cost": (float(read + F64), 60.0 * M)}

"""Schur-complement elimination of points: the reduced camera system of the
indexed (observation-list) engine, PyTorch port of
``deeparc_tpu.solver.schur`` (Ceres' DENSE_SCHUR / ITERATIVE_SCHUR, selected
by the reference at ``src/sfm.cc:67,95``). The normal equations of one LM
iteration,

    [ B   E ] [dp]   [-g_p]        B: (N, 3, 3) per-point blocks
    [ E^T C ] [dc] = [-g_c]        C: (C, C) camera-camera

are solved by eliminating every point's 3x3 block in closed form and
solving the reduced camera system

    S dc = -g_c + E^T B^-1 g_p,    S = C - E^T B^-1 E

densely (Cholesky, ``dense_schur``) or matrix-free by preconditioned CG
(``iterative_schur``); back-substitution gives dp = -B^-1 (g_p + E dc).

Every per-observation array is rank 2 with M leading: residual and
Jacobian blocks are packed into one (M, 44) buffer, columns [0:2) residual,
[2:8) d res/d point (r*3+i), [8:44) d res/d camera (r*18+c).

The camera side's 18 columns are three groups of 6 keyed by outer
extrinsic / inner extrinsic / intrinsic id, so every accumulation over
observations is a row sum by one key (:func:`kernels.tile.sum_rows`): on
the card the fixed-order gather kernel through maps built once per solve
(:func:`schur_maps`, the index does not change within a solve), so one LM
step repeats bit for bit; on CPU tensors ``index_add_``.

Frozen columns (gauge, frozen intrinsics, the freeze-camera pre-solve,
``src/sfm.cc:50-63``) are zeroed in J and their rows of S replaced by
identity, so frozen deltas are exactly zero.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.kernels.tile import gather_map, sum_rows
from deeparc_tpu_torch.residuals.reprojection import camera_col_indices
from deeparc_tpu_torch.solver.linalg import (
    inv3x3,
    masked_spd_solve,
    pcg,
    pcg_device,
)
from deeparc_tpu_torch.solver.trust_region import lm_diagonal

# a camera row's sources are cut into segments of this many observations,
# each summed by its own block, then the segments in order (gather_map)
CAM_SEGMENT = 512


class SchurMaps(NamedTuple):
    """The fixed-order maps (:func:`kernels.tile.gather_map`) of every row
    sum of one solve; they depend on the index only."""

    point: tuple            # obs_point -> N points
    outer: tuple            # obs_outer -> R extrinsic rows (segmented)
    inner: tuple            # obs_inner -> R extrinsic rows (segmented)
    intr: tuple             # obs_intr -> K intrinsics (segmented)
    dense_e: tuple = ()     # per group: obs_point * R_g + id_g -> N * R_g
    hcc: tuple = ()         # per group pair: id1 * R2 + id2 -> R1 * R2


def schur_maps(index, n_points: int, n_ext_rows: int, n_intr: int,
               dense: bool = True) -> SchurMaps:
    """The maps of one solve's row sums; ``dense`` adds those of
    :func:`dense_S` (E's full-grid sums and the nine Hcc blocks)."""
    op = index.obs_point.long()
    ids = (index.obs_outer.long(), index.obs_inner.long(),
           index.obs_intr.long())
    sizes = (n_ext_rows, n_ext_rows, n_intr)
    cam = [gather_map(i, n, CAM_SEGMENT) for i, n in zip(ids, sizes)]
    maps = SchurMaps(gather_map(op, n_points), *cam)
    if not dense:
        return maps
    dense_e = tuple(gather_map(op * n + i, n_points * n)
                    for i, n in zip(ids, sizes))
    hcc = tuple(gather_map(i1 * n2 + i2, n1 * n2, CAM_SEGMENT)
                for i1, n1 in zip(ids, sizes) for i2, n2 in zip(ids, sizes))
    return maps._replace(dense_e=dense_e, hcc=hcc)


class SchurSystem(NamedTuple):
    """One linearization, masked and ready for (possibly repeated) solves."""

    jrc: torch.Tensor        # (M, 44) packed [r | j_point | j_cam]
    obs_point: torch.Tensor  # (M,)
    obs_outer: torch.Tensor  # (M,) outer-extrinsic row ids
    obs_inner: torch.Tensor  # (M,) inner-extrinsic row ids
    obs_intr: torch.Tensor   # (M,) intrinsic ids
    n_ext_rows: int          # extrinsic rows incl. the identity slot
    n_intr: int
    g_p: torch.Tensor        # (N, 3)
    g_c: torch.Tensor        # (C,)
    hpp: torch.Tensor        # (N, 3, 3)
    hcc_diag: torch.Tensor   # (C,)
    cam_free: torch.Tensor   # (C,) 0/1
    point_free: torch.Tensor  # (N, 3) 0/1
    maps: SchurMaps | None = None


# -- packed-buffer accessors -------------------------------------------------

def sys_r(sys: SchurSystem) -> torch.Tensor:
    """(M, 2) residuals."""
    return sys.jrc[:, 0:2]


def sys_jp(sys: SchurSystem) -> torch.Tensor:
    """(M, 6) point Jacobian, columns r*3+i."""
    return sys.jrc[:, 2:8]


def sys_jc(sys: SchurSystem) -> torch.Tensor:
    """(M, 36) camera Jacobian, columns r*18+c."""
    return sys.jrc[:, 8:44]


def sys_cols(sys: SchurSystem) -> torch.Tensor:
    """(M, 18) flat camera-vector column ids (computed, never stored)."""
    return camera_col_indices(sys, sys.n_ext_rows)


# -- flat contraction helpers (all outputs rank 2, M leading) ----------------

def _jp_r(jp, t2):
    """sum_r jp[m, r*3+i] * t[m, r] -> (M, 3)."""
    return jp[:, 0:3] * t2[:, 0:1] + jp[:, 3:6] * t2[:, 1:2]


def _jc_r(jc, t2):
    """sum_r jc[m, r*18+c] * t[m, r] -> (M, 18)."""
    return jc[:, 0:18] * t2[:, 0:1] + jc[:, 18:36] * t2[:, 1:2]


def _jp_dot(jp, v3):
    """sum_i jp[m, r*3+i] * v[m, i] -> (M, 2)."""
    return torch.stack([torch.sum(jp[:, 0:3] * v3, dim=1),
                        torch.sum(jp[:, 3:6] * v3, dim=1)], dim=1)


def _jc_dot(jc, v18):
    """sum_c jc[m, r*18+c] * v[m, c] -> (M, 2)."""
    return torch.stack([torch.sum(jc[:, 0:18] * v18, dim=1),
                        torch.sum(jc[:, 18:36] * v18, dim=1)], dim=1)


def _outer_cols(a0, a1, b0, b1):
    """sum_r a_r[m, i] * b_r[m, j] flattened -> (M, ka*kb), cols i*kb+j."""
    ka = a0.shape[1]
    return torch.cat([a0[:, i:i + 1] * b0 + a1[:, i:i + 1] * b1
                      for i in range(ka)], dim=1)


def _maps(sys: SchurSystem) -> SchurMaps:
    if sys.maps is not None:
        return sys.maps
    empty = ((),) * 3
    return SchurMaps((), (), (), (), empty, ((),) * 9)


def _point_sum(sys: SchurSystem, vals: torch.Tensor) -> torch.Tensor:
    """Per-observation rows summed into the N points."""
    return sum_rows(vals, sys.obs_point, sys.point_free.shape[0],
                    _maps(sys).point)


def cam_accumulate(sys: SchurSystem, vals: torch.Tensor) -> torch.Tensor:
    """Per-observation 18-wide camera values summed into the flat (C,)
    camera vector: three row sums, one per column group of 6, keyed by the
    outer, inner and intrinsic ids (group g of observation m lands at rows
    id_g(m) * 6 .. + 6 of its region)."""
    m = _maps(sys)
    R, K = sys.n_ext_rows, sys.n_intr
    ext = (sum_rows(vals[:, 0:6], sys.obs_outer, R, m.outer)
           + sum_rows(vals[:, 6:12], sys.obs_inner, R, m.inner))
    intr = sum_rows(vals[:, 12:18], sys.obs_intr, K, m.intr)
    return torch.cat([ext.reshape(-1), intr.reshape(-1)])


def build_system(r: torch.Tensor, j_point: torch.Tensor, j_cam: torch.Tensor,
                 index, n_points: int, n_ext_rows: int, n_intr: int,
                 cam_free: torch.Tensor, point_free: torch.Tensor,
                 maps: SchurMaps | None = None) -> SchurSystem:
    """Assemble the masked system from Jacobian blocks and an index with
    (obs_point, obs_outer, obs_inner, obs_intr). Blocks may be flat
    ((M,2)/(M,6)/(M,36)) or rank 3 ((M,2,3)/(M,2,18), reshaped row-major,
    which is the flat column convention). ``maps`` (:func:`schur_maps` of
    ``index``) is required on the card."""
    M = r.shape[0]
    jp = j_point.reshape(M, 6)
    jc = j_cam.reshape(M, 36)
    free18 = cam_free[camera_col_indices(index, n_ext_rows)]
    jc = jc * torch.cat([free18, free18], dim=1)
    pf3 = point_free[index.obs_point.long()]
    jp = jp * torch.cat([pf3, pf3], dim=1)
    jrc = torch.cat([r, jp, jc], dim=1)

    sys = SchurSystem(
        jrc=jrc, obs_point=index.obs_point, obs_outer=index.obs_outer,
        obs_inner=index.obs_inner, obs_intr=index.obs_intr,
        n_ext_rows=n_ext_rows, n_intr=n_intr, g_p=None, g_c=None, hpp=None,
        hcc_diag=None, cam_free=cam_free, point_free=point_free, maps=maps)
    # one (M, 12) row sum carries g_p and the 3x3 point Hessian
    hpp9 = _outer_cols(jp[:, 0:3], jp[:, 3:6], jp[:, 0:3], jp[:, 3:6])
    gp_hpp = _point_sum(sys, torch.cat([_jp_r(jp, r), hpp9], dim=1))
    g_c = cam_accumulate(sys, _jc_r(jc, r))
    hcc_diag = cam_accumulate(
        sys, jc[:, 0:18] * jc[:, 0:18] + jc[:, 18:36] * jc[:, 18:36])
    return sys._replace(g_p=gp_hpp[:, 0:3],
                        hpp=gp_hpp[:, 3:12].reshape(n_points, 3, 3),
                        g_c=g_c, hcc_diag=hcc_diag)


def augmented_point_blocks(hpp: torch.Tensor, point_free: torch.Tensor,
                           radius: torch.Tensor,
                           options: SolverOptions) -> torch.Tensor:
    """B~^-1: inverses of the LM-augmented per-point 3x3 blocks ``hpp``
    (frozen coordinates get identity rows, and their gradient is already
    zero). Every engine's step takes its point blocks from here."""
    diag = torch.diagonal(hpp, dim1=-2, dim2=-1)
    d2 = lm_diagonal(diag, options.min_lm_diagonal, options.max_lm_diagonal)
    eye = torch.eye(3, dtype=hpp.dtype, device=hpp.device)
    aug = hpp + eye * d2[:, :, None] / radius
    aug = aug + (1.0 - point_free)[:, :, None] * eye
    return inv3x3(aug)


def _cam_aug_diag(sys: SchurSystem, radius: torch.Tensor,
                  options: SolverOptions) -> torch.Tensor:
    d2 = lm_diagonal(sys.hcc_diag, options.min_lm_diagonal,
                     options.max_lm_diagonal)
    return d2 / radius


def schur_matvec(sys: SchurSystem, binv: torch.Tensor, cam_aug: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Apply S = (Hcc + aug) - E^T B~^-1 E matrix-free; frozen rows act as I."""
    jp, jc = sys_jp(sys), sys_jc(sys)
    t = _jc_dot(jc, v[sys_cols(sys)])
    hcc_v = cam_accumulate(sys, _jc_r(jc, t))
    ev = _point_sum(sys, _jp_r(jp, t))
    w = torch.einsum("pij,pj->pi", binv, ev)
    t2 = _jp_dot(jp, w[sys.obs_point.long()])
    corr = cam_accumulate(sys, _jc_r(jc, t2))
    s = hcc_v + cam_aug * v - corr
    return torch.where(sys.cam_free > 0.5, s, v)


def _groups(sys: SchurSystem):
    """(ids, rows, column offset in the 18, flat column offset) per column
    group. The camera vector is [ext rows | intr rows]; the outer and the
    inner extrinsic groups both land in the ext region."""
    R, K = sys.n_ext_rows, sys.n_intr
    return ((sys.obs_outer, R, 0, 0), (sys.obs_inner, R, 6, 0),
            (sys.obs_intr, K, 12, 6 * R))


def _jc_group(jc, off):
    """The two per-residual-row 6-wide slices of one column group."""
    return jc[:, off:off + 6], jc[:, 18 + off:18 + off + 6]


def _dense_E(sys: SchurSystem) -> torch.Tensor:
    """E (N, 3, C) from full-grid row sums: for group g with R_g rows, the
    per-observation 3x6 block W = J_point^T J_cam[:, g] is summed by key
    point * R_g + id_g, and the (N * R_g, 18) result is E restricted to
    the group. Memory O(N * (2 R + K) * 18): the dense path is for rigs."""
    n_points, n_cam = sys.g_p.shape[0], sys.g_c.shape[0]
    jp, jc = sys_jp(sys), sys_jc(sys)
    op = sys.obs_point.long()
    E = torch.zeros((n_points, 3, n_cam), dtype=sys.jrc.dtype,
                    device=sys.jrc.device)
    for (ids, R_g, off, flat_off), gmap in zip(_groups(sys),
                                               _maps(sys).dense_e):
        g0, g1 = _jc_group(jc, off)
        W = _outer_cols(jp[:, 0:3], jp[:, 3:6], g0, g1)      # (M, 18) i*6+c
        grid = sum_rows(W, op * R_g + ids.long(), n_points * R_g, gmap)
        part = grid.reshape(n_points, R_g, 3, 6).permute(0, 2, 1, 3)
        E[:, :, flat_off:flat_off + 6 * R_g] += part.reshape(
            n_points, 3, 6 * R_g)
    return E


def reduced_rhs(sys: SchurSystem, binv: torch.Tensor) -> torch.Tensor:
    """-g_c + E^T B~^-1 g_p."""
    jp, jc = sys_jp(sys), sys_jc(sys)
    w_g = torch.einsum("pij,pj->pi", binv, sys.g_p)
    t_g = _jp_dot(jp, w_g[sys.obs_point.long()])
    return -sys.g_c + cam_accumulate(sys, _jc_r(jc, t_g))


def back_substitute(sys: SchurSystem, binv: torch.Tensor,
                    dc: torch.Tensor) -> torch.Tensor:
    """dp = -B~^-1 (g_p + E dc)."""
    jp, jc = sys_jp(sys), sys_jc(sys)
    t_dc = _jc_dot(jc, dc[sys_cols(sys)])
    e_dc = _point_sum(sys, _jp_r(jp, t_dc))
    dp = -torch.einsum("pij,pj->pi", binv, sys.g_p + e_dc)
    return dp * sys.point_free


def hcc_dense(sys: SchurSystem) -> torch.Tensor:
    """Hcc = sum_m A_m^T A_m as a dense (C, C) matrix from the nine group
    pairs' full-grid row sums (key id1 * R2 + id2 covers the block grid,
    so each sum reshapes straight into its dense block)."""
    n_cam = sys.g_c.shape[0]
    jc = sys_jc(sys)
    hcc = torch.zeros((n_cam, n_cam), dtype=sys.jrc.dtype,
                      device=sys.jrc.device)
    groups = _groups(sys)
    pairs = [(g1, g2) for g1 in groups for g2 in groups]
    for ((ids1, R1, off1, flat1), (ids2, R2, off2, flat2)), gmap in zip(
            pairs, _maps(sys).hcc):
        a0, a1 = _jc_group(jc, off1)
        b0, b1 = _jc_group(jc, off2)
        blocks = _outer_cols(a0, a1, b0, b1)                  # (M, 36)
        grid = sum_rows(blocks, ids1.long() * R2 + ids2.long(), R1 * R2, gmap)
        dense = grid.reshape(R1, R2, 6, 6).permute(0, 2, 1, 3).reshape(
            6 * R1, 6 * R2)
        hcc[flat1:flat1 + 6 * R1, flat2:flat2 + 6 * R2] += dense
    return hcc


def dense_S(sys: SchurSystem, binv: torch.Tensor) -> torch.Tensor:
    """Hcc - E^T B~^-1 E as a dense (C, C) matrix, WITHOUT the LM diagonal."""
    E = _dense_E(sys)
    N, C = E.shape[0], E.shape[2]
    be = torch.einsum("pij,pjd->pid", binv, E)
    return hcc_dense(sys) - E.reshape(N * 3, C).T @ be.reshape(N * 3, C)


def block_jacobi_preconditioner(sys: SchurSystem, cam_aug: torch.Tensor):
    """6x6 block-Jacobi preconditioner from the Hcc block diagonal and the
    LM augmentation (Ceres' SCHUR_JACOBI analogue); frozen coordinates get
    identity rows, so the operator stays SPD and acts as I on them."""
    R, K = sys.n_ext_rows, sys.n_intr
    jc = sys_jc(sys)
    m = _maps(sys)

    def group_blocks(off, ids, n, gmap):
        a0, a1 = _jc_group(jc, off)
        return sum_rows(_outer_cols(a0, a1, a0, a1), ids, n,
                        gmap).reshape(n, 6, 6)

    ext = (group_blocks(0, sys.obs_outer, R, m.outer)
           + group_blocks(6, sys.obs_inner, R, m.inner))
    intr = group_blocks(12, sys.obs_intr, K, m.intr)
    blocks = torch.cat([ext, intr], dim=0)                   # (R + K, 6, 6)
    aug = cam_aug.reshape(R + K, 6)
    frozen = 1.0 - sys.cam_free.reshape(R + K, 6)
    eye6 = torch.eye(6, dtype=blocks.dtype, device=blocks.device)
    # inv_ex: linalg.inv's result without its host-side error check
    inv_blocks = torch.linalg.inv_ex(
        blocks + eye6 * (aug + frozen)[:, :, None]).inverse

    def precond(v):
        return torch.einsum("bij,bj->bi", inv_blocks,
                            v.reshape(R + K, 6)).reshape(-1)

    return precond


def solve_schur(sys: SchurSystem, radius: torch.Tensor,
                options: SolverOptions, device_loop: bool = False) -> tuple:
    """Solve the augmented normal equations; returns (dp (N,3), dc (C,)).
    ``device_loop`` runs PCG as :func:`solver.linalg.pcg_device` (the
    ``while_loop`` driver)."""
    binv = augmented_point_blocks(sys.hpp, sys.point_free, radius, options)
    cam_aug = _cam_aug_diag(sys, radius, options)
    rhs = reduced_rhs(sys, binv) * sys.cam_free
    if options.linear_solver == "dense_schur":
        S = dense_S(sys, binv) + torch.diag(cam_aug)
        dc = masked_spd_solve(S, rhs, sys.cam_free)
    elif options.linear_solver == "iterative_schur":
        if options.preconditioner == "block_jacobi":
            precond = block_jacobi_preconditioner(sys, cam_aug)
        else:
            precond_diag = torch.where(
                sys.cam_free > 0.5,
                1.0 / (sys.hcc_diag + cam_aug + 1e-300),
                torch.ones_like(cam_aug))
            precond = lambda v: precond_diag * v
        result = (pcg_device if device_loop else pcg)(
            lambda v: schur_matvec(sys, binv, cam_aug, v), rhs,
            precond=precond, max_iterations=options.cg_max_iterations,
            tol=options.cg_tolerance)
        dc = result.x * sys.cam_free
    else:
        raise ValueError(f"unknown linear_solver {options.linear_solver!r}")
    return back_substitute(sys, binv, dc), dc


def j_times(sys: SchurSystem, dp: torch.Tensor,
            dc: torch.Tensor) -> torch.Tensor:
    """J [dp; dc] per observation (M, 2), for the model-cost-change test."""
    jp, jc = sys_jp(sys), sys_jc(sys)
    return (_jp_dot(jp, dp[sys.obs_point.long()])
            + _jc_dot(jc, dc[sys_cols(sys)]))

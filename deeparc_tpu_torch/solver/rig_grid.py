"""Dense-grid bundle adjustment for shared-extrinsic rigs, PyTorch port of
``deeparc_tpu.solver.rig_grid``.

A camera cell is an (arc, ring) pair whose extrinsic/intrinsic ids depend
only on the cell, so observations lie on a dense (N points x T cells) grid
with a visibility mask. Each LM step linearizes, eliminates the 3x3 point
blocks, solves the reduced camera system exactly with a dense Cholesky
(DENSE_SCHUR, ``src/sfm.cc:67``) and evaluates the trial point with a cost
pass. ``impl`` picks the linearize and the cost pass, with the reference's
names:

  * ``"auto"`` / ``"pallas"``: the fused grid kernels
    (``kernels/rig_grid.py``: banded when ``band_grid`` found locality,
    monolithic otherwise), on the card the hand CUDA kernels, on the CPU
    their plain versions;
  * ``"planes"`` / ``"einsum"``: the monolithic kernels' plain PyTorch
    versions on any device, E in flat camera order (the reference's two
    XLA bodies compute the same function; one torch path stands for both).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.geometry.rotation import (
    angle_axis_to_matrix,
    so3_right_jacobian,
)
from deeparc_tpu_torch.residuals.reprojection import (
    flatten_camera,
    unflatten_camera,
)
from deeparc_tpu_torch.scene import BAParams, Scene
from deeparc_tpu_torch.solver import trust_region as tr_mod
from deeparc_tpu_torch.solver.ba import (
    BAResult,
    check_driver,
    load_checkpoint,
    run_steps,
    tr_of,
)
from deeparc_tpu_torch.solver.linalg import masked_spd_solve
from deeparc_tpu_torch.solver.schur import augmented_point_blocks
from deeparc_tpu_torch.utils.profiling import span, traced


@dataclasses.dataclass
class GridIndex:
    """Dense (N points x T cells) observation grid + per-cell structure."""

    xy0: torch.Tensor          # (N, T) observed pixel x (0 where masked)
    xy1: torch.Tensor          # (N, T) observed pixel y
    mask: torch.Tensor         # (N, T) 1.0 = observed
    point_mask: torch.Tensor   # (N,)
    slot_outer: torch.Tensor   # (T,) int32 extrinsic row ids
    slot_inner: torch.Tensor   # (T,)
    slot_intr: torch.Tensor    # (T,)
    onehot_outer: torch.Tensor  # (T, R)
    onehot_inner: torch.Tensor  # (T, R)
    onehot_intr: torch.Tensor   # (T, K)
    focal_shared: torch.Tensor  # (T,)
    dist_m1: torch.Tensor       # (T,)
    dist_m2: torch.Tensor       # (T,)
    # live-band tables from solver/rig_band.band_grid: (starts_lin,
    # starts_cost[, pxm_lin groups, pxm_cost groups])
    band: tuple = ()


def grid_from_scene(scene: Scene, dtype=None) -> GridIndex:
    """Densify the observation list onto the (N, A*R) cell grid, on the
    scene's device. Only LIVE observations are scattered, and their
    (point, cell) pairs must be unique: a scatter of duplicates has no
    defined winner."""
    if not scene.meta.share_extrinsic:
        raise ValueError("grid layout requires a shared-extrinsic rig scene")
    A, R_rings = scene.meta.arc_size, scene.meta.ring_size
    T, N = A * R_rings, scene.n_points
    dtype = dtype or scene.params.points.dtype
    dev = scene.params.points.device

    arc = np.repeat(np.arange(A), R_rings).astype(np.int64)
    ring = np.tile(np.arange(R_rings), A).astype(np.int64)
    ring_rec = np.where(ring == 0, 0, ring + A - 1)
    identity = scene.identity_ext
    outer = np.where(ring == 0, arc, np.where(arc == 0, ring_rec, arc))
    inner = np.where((ring == 0) | (arc == 0), identity, ring_rec)
    intr = arc

    cell = torch.as_tensor(scene.meta.obs_arc.astype(np.int64) * R_rings
                           + scene.meta.obs_ring.astype(np.int64), device=dev)
    live = scene.index.obs_mask > 0.5
    op = scene.index.obs_point.long()[live]
    cell = cell[live]
    keys = op * T + cell
    if torch.unique(keys).numel() != keys.numel():
        raise ValueError("two live observations share one (point, cell) "
                         "pair; the dense grid holds one per pair")
    xy = scene.index.obs_xy[live].to(dtype)
    xy0 = torch.zeros((N, T), dtype=dtype, device=dev)
    xy1 = torch.zeros((N, T), dtype=dtype, device=dev)
    mask = torch.zeros((N, T), dtype=dtype, device=dev)
    xy0[op, cell] = xy[:, 0]
    xy1[op, cell] = xy[:, 1]
    mask[op, cell] = scene.index.obs_mask[live].to(dtype)

    n_ext_rows = scene.params.ext_rot.shape[0]
    K = scene.n_intrinsics

    def onehot(ids, n):
        out = np.zeros((T, n))
        out[np.arange(T), ids] = 1.0
        return torch.as_tensor(out, dtype=dtype, device=dev)

    per_intr = lambda t: t.to(dtype)[torch.as_tensor(intr, device=dev)]
    i32 = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
    return GridIndex(
        xy0=xy0, xy1=xy1, mask=mask,
        point_mask=scene.index.point_mask.to(dtype),
        slot_outer=i32(outer), slot_inner=i32(inner), slot_intr=i32(intr),
        onehot_outer=onehot(outer, n_ext_rows),
        onehot_inner=onehot(inner, n_ext_rows),
        onehot_intr=onehot(intr, K),
        focal_shared=per_intr(scene.index.focal_shared),
        dist_m1=per_intr(scene.index.dist_m1),
        dist_m2=per_intr(scene.index.dist_m2),
    )


class SlotParams(NamedTuple):
    """Per-cell camera quantities (all (T, ...))."""

    R_i: torch.Tensor
    R_o: torch.Tensor
    R_oi: torch.Tensor
    t_i: torch.Tensor
    t_o: torch.Tensor
    Jr_o: torch.Tensor
    Jr_i: torch.Tensor
    center: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    d0: torch.Tensor   # masked by m1
    d1: torch.Tensor   # masked by m2


def slot_params(params: BAParams, grid: GridIndex) -> SlotParams:
    so, si = grid.slot_outer.long(), grid.slot_inner.long()
    sk = grid.slot_intr.long()
    w_o, w_i = params.ext_rot[so], params.ext_rot[si]
    R_o, R_i = angle_axis_to_matrix(w_o), angle_axis_to_matrix(w_i)
    focal, dist = params.focal[sk], params.dist[sk]
    return SlotParams(
        R_i=R_i, R_o=R_o, R_oi=R_o @ R_i,
        t_i=params.ext_trans[si], t_o=params.ext_trans[so],
        Jr_o=so3_right_jacobian(w_o), Jr_i=so3_right_jacobian(w_i),
        center=params.center[sk], fx=focal[:, 0],
        fy=torch.where(grid.focal_shared > 0.5, focal[:, 0], focal[:, 1]),
        d0=dist[:, 0] * grid.dist_m1, d1=dist[:, 1] * grid.dist_m2,
    )


def grid_residuals(points: torch.Tensor, sp: SlotParams,
                   grid: GridIndex) -> torch.Tensor:
    """Masked residuals (N, T, 2), evaluated on (N, T) planes."""
    from deeparc_tpu_torch.solver.rig_planes import _project_planes

    c = _project_planes(points, sp, grid.xy0, grid.xy1, grid.mask)
    return torch.stack([c["r0"], c["r1"]], dim=-1)


class GridSystem(NamedTuple):
    cost: torch.Tensor   # scalar
    g_p: torch.Tensor    # (N, 3)
    hpp: torch.Tensor    # (N, 3, 3)
    g_c: torch.Tensor    # (C,) flat camera order
    hcc: torch.Tensor    # (C, C) flat camera order
    E: torch.Tensor      # (N, 3, Cn) the kernels' native column order on
                         # the kernel path, flat camera order otherwise


# the grid engine's linearize / cost-pass implementations: the kernels
# (the hand CUDA kernels on the card, their plain versions on the CPU),
# then the torch paths
KERNEL_IMPLS = ("auto", "pallas")
GRID_IMPLS = KERNEL_IMPLS + ("planes", "einsum")


def _check_impl(impl: str) -> bool:
    """True for the kernel path; raises for an impl the grid engine does
    not have."""
    if impl not in GRID_IMPLS:
        raise ValueError(f"unknown grid impl {impl!r}; one of {GRID_IMPLS}")
    return impl in KERNEL_IMPLS


def _bin_slot_system(g_slots, hcc_slots, grid, C, dtype):
    """Fold per-slot (T, 18) / (T, 18, 18) pieces into the flat camera
    gradient (C,) and dense H_cc (C, C) via the one-hot bin matrices."""
    R_rows = grid.onehot_outer.shape[1]
    g_ext = (torch.einsum("tr,tj->rj", grid.onehot_outer, g_slots[:, 0:6])
             + torch.einsum("tr,tj->rj", grid.onehot_inner, g_slots[:, 6:12]))
    g_c = torch.cat([g_ext.reshape(-1),
                     torch.einsum("tk,tj->kj", grid.onehot_intr,
                                  g_slots[:, 12:18]).reshape(-1)])
    groups = ((grid.onehot_outer, slice(0, 6), 0),
              (grid.onehot_inner, slice(6, 12), 0),
              (grid.onehot_intr, slice(12, 18), 6 * R_rows))
    hcc = torch.zeros((C, C), dtype=dtype, device=g_slots.device)
    for oh_a, sl_a, off_a in groups:
        Ra = oh_a.shape[1]
        for oh_b, sl_b, off_b in groups:
            Rb = oh_b.shape[1]
            dense = torch.einsum("tij,tu,tv->uivj", hcc_slots[:, sl_a, sl_b],
                                 oh_a, oh_b).reshape(6 * Ra, 6 * Rb)
            hcc[off_a:off_a + 6 * Ra, off_b:off_b + 6 * Rb] += dense
    return g_c, hcc


def _flat_columns(E_nat: torch.Tensor, R: int, K: int) -> torch.Tensor:
    """E from the kernels' native column order
    (:func:`kernels.rig_grid.native_of_flat`) to flat camera order."""
    N = E_nat.shape[0]
    ext = E_nat[..., :6 * R].reshape(N, 3, 6, R).transpose(-1, -2)
    intr = E_nat[..., 6 * R:].reshape(N, 3, 6, K).transpose(-1, -2)
    return torch.cat([ext.reshape(N, 3, 6 * R), intr.reshape(N, 3, 6 * K)],
                     dim=-1)


def slot_free(cam_free: torch.Tensor, grid: GridIndex) -> tuple:
    """The flat free camera mask as the linearize takes it: per cell, the
    free masks (T, 6) of its outer and inner extrinsic rows and of its
    intrinsic row."""
    R_rows, K = grid.onehot_outer.shape[1], grid.onehot_intr.shape[1]
    rows = cam_free[: 6 * R_rows].reshape(R_rows, 6)
    intr = cam_free[6 * R_rows:].reshape(K, 6)
    return (rows[grid.slot_outer.long()], rows[grid.slot_inner.long()],
            intr[grid.slot_intr.long()])


def assemble_grid_system(points, sp, grid, cam_free, point_free,
                         chunk_size: int = 8192, loss: str = "trivial",
                         loss_scale: float = 0.5, impl: str = "auto",
                         band_width=0, band_block: int = 0,
                         band_intr_frozen: bool = False,
                         pxm=None) -> GridSystem:
    """Linearize and bin the slot pieces into the flat camera system.

    On the kernel path (``impl`` "auto" / "pallas") the fused grid kernels
    linearize, banded when ``band_width`` and the grid's band tables are
    given; ``E`` stays in the kernels' native column order. ``pxm`` is the
    monolithic kernels' plane stack (``kernels.rig_grid.mono_planes``),
    built by the kernel wrapper when not given. ``impl="planes"`` /
    ``"einsum"`` run the monolithic kernel's plain version on any device
    (``pxm`` as there), ``E`` in flat order. ``g_c``/``hcc`` are in flat
    order on every path."""
    from deeparc_tpu_torch.kernels.rig_grid import (
        linearize_grid,
        linearize_grid_banded,
        linearize_grid_plain,
    )

    R_rows = grid.onehot_outer.shape[1]
    K = grid.onehot_intr.shape[1]
    C = 6 * R_rows + 6 * K
    free_outer, free_inner, free_intr = slot_free(cam_free, grid)
    kernels = _check_impl(impl)
    if kernels and band_width and grid.band:
        out = linearize_grid_banded(
            points, point_free, sp, grid, free_outer, free_inner, free_intr,
            grid.band[0], w_band=band_width, loss=loss, loss_scale=loss_scale,
            block_np=band_block or min(chunk_size, 256),
            intr_frozen=band_intr_frozen,
            pxm=grid.band[2] if len(grid.band) > 2 else None)
    else:
        out = (linearize_grid if kernels else linearize_grid_plain)(
            points, point_free, sp, grid, free_outer, free_inner, free_intr,
            loss=loss, loss_scale=loss_scale, block_np=min(chunk_size, 256),
            pxm=pxm)
    cost, g_p, hpp, g_slots, hcc_slots, E = out
    g_c, hcc = _bin_slot_system(g_slots, hcc_slots, grid, C, points.dtype)
    if not kernels:
        E = _flat_columns(E, R_rows, K)
    return GridSystem(cost=cost, g_p=g_p, hpp=hpp, g_c=g_c, hcc=hcc, E=E)


def grid_cost(points, sp, grid, chunk_size: int = 16384,
              loss: str = "trivial", loss_scale: float = 0.5,
              impl: str = "auto", band_width=0, band_block: int = 0,
              pxm=None) -> torch.Tensor:
    """Residual-only (robustified) cost pass: the fused cost kernels on the
    kernel path, the monolithic cost kernel's plain version for
    ``impl="planes"`` / ``"einsum"`` (``pxm`` as for
    :func:`assemble_grid_system`)."""
    from deeparc_tpu_torch.kernels.rig_grid import (
        cost_grid,
        cost_grid_banded,
        cost_grid_plain,
    )

    kernels = _check_impl(impl)
    if kernels and band_width and grid.band:
        return cost_grid_banded(
            points, sp, grid, grid.band[1], w_band=band_width, loss=loss,
            loss_scale=loss_scale, block_np=band_block or min(chunk_size, 1024),
            pxm=grid.band[3] if len(grid.band) > 3 else None)
    return (cost_grid if kernels else cost_grid_plain)(
        points, sp, grid, loss=loss, loss_scale=loss_scale,
        block_np=min(chunk_size, 1024), pxm=pxm)


class GridState(NamedTuple):
    points: torch.Tensor    # (N, 3)
    cam_vec: torch.Tensor   # (C,) flattened camera vector
    cost: torch.Tensor
    tr: tr_mod.TRState
    k: int
    status: torch.Tensor


class GridStateF(NamedTuple):
    """The fused-trial step's state (``make_grid_step(fuse_trial=True)``):
    it carries the linearized system at its iterate, and ``cost ==
    sys.cost`` always (two buffers of one value)."""

    points: torch.Tensor
    cam_vec: torch.Tensor
    cost: torch.Tensor
    sys: GridSystem
    tr: tr_mod.TRState
    k: int
    status: torch.Tensor


def _params_from(cam_vec, points, template: BAParams) -> BAParams:
    return dataclasses.replace(unflatten_camera(cam_vec, template),
                               points=points)


def _same(x):
    return x


def reductions(reducer):
    """(sum, max, symmetric sum) over the ranks of ``reducer``; identities
    without one (the single-device step)."""
    if reducer is None:
        return _same, _same, _same
    return reducer.sum, reducer.max, reducer.sum_sym


def column_maps(template: BAParams, kernels: bool, ext_only: bool):
    """(to_flat, to_nat): C-sized vectors and (C, C) matrices from E's
    column order to the flat camera order and back. Only C-sized
    quantities are ever permuted, never E. The kernel path's E has the
    kernels' native order (``kernels.rig_grid.native_of_flat``); banded
    with frozen intrinsics (``ext_only``) it comes back ext-only (N, 3,
    6R): its columns are the first 6R flat columns, zeros elsewhere. The
    torch paths' E is in flat order: identities."""
    from deeparc_tpu_torch.kernels.rig_grid import (
        flat_of_native,
        native_of_flat,
    )

    if not kernels:
        same = lambda v: v
        return same, same
    R_rows, K = template.ext_rot.shape[0], template.center.shape[0]
    dev = template.points.device
    C_full, ce = 6 * (R_rows + K), 6 * R_rows
    k_e = 0 if ext_only else K
    n2f = torch.as_tensor(native_of_flat(R_rows, k_e), device=dev).long()
    f2n = torch.as_tensor(flat_of_native(R_rows, k_e), device=dev).long()

    def to_flat(v):
        if not ext_only:
            return v[n2f] if v.ndim == 1 else v[n2f][:, n2f]
        out = torch.zeros((C_full,) * v.ndim, dtype=v.dtype, device=dev)
        if v.ndim == 1:
            out[:ce] = v[n2f]
        else:
            out[:ce, :ce] = v[n2f][:, n2f]
        return out

    def to_nat(v):
        return v[:ce][f2n] if ext_only else v[f2n]

    return to_flat, to_nat


# ---------------------------------------------------------------------------
# The step's Schur solve, piece by piece (``scripts/profile_grid.py`` times
# each). ``to_flat`` / ``to_nat`` are :func:`column_maps`; ``allsum`` /
# ``allsum_sym`` the sharded step's sums over ranks (:func:`reductions`).
# ---------------------------------------------------------------------------


def schur_point_blocks(sys, radius, point_free, options: SolverOptions):
    """(B^-1, D_c): the inverse LM-augmented point blocks and the camera
    LM diagonal."""
    binv = augmented_point_blocks(sys.hpp, point_free, radius, options)
    d2c = tr_mod.lm_diagonal(torch.diagonal(sys.hcc),
                             options.min_lm_diagonal, options.max_lm_diagonal)
    return binv, d2c


def _e2(sys):
    N, Cn = sys.E.shape[0], sys.E.shape[2]
    return sys.E.reshape(N * 3, Cn)


def schur_reduce(sys, binv, cam_free, to_flat, allsum=_same,
                 allsum_sym=_same):
    """(rhs, corr): the reduced gradient -g_c + E2.T @ (B^-1 g_p) on the
    free coordinates and the Schur correction E2.T @ B^-1 E2, (C, C), both
    in flat order, from one pass over E (``kernels.rig_grid.
    schur_reduce``: its kernel on the card, its plain version on the
    CPU)."""
    from deeparc_tpu_torch.kernels.rig_grid import schur_reduce as one_pass

    corr, v = one_pass(sys.E, binv, sys.g_p)
    rhs = (-sys.g_c + allsum(to_flat(v))) * cam_free
    return rhs, allsum_sym(to_flat(corr))


def schur_cameras(sys, d2c, corr, rhs, radius, cam_free):
    """dc: S = H_cc + D_c / radius - corr solved against ``rhs`` on the
    free coordinates."""
    S = sys.hcc + torch.diag(d2c / radius) - corr
    return masked_spd_solve(S, rhs, cam_free)


def schur_back(sys, binv, dc, point_free, to_nat):
    """The back-substitution: (e_dc = E dc, dp = -B^-1 (g_p + e_dc))."""
    N = sys.E.shape[0]
    e_dc = (_e2(sys) @ to_nat(dc)).reshape(N, 3)
    dp = -torch.einsum("pij,pj->pi", binv, sys.g_p + e_dc) * point_free
    return e_dc, dp


def make_grid_step(options: SolverOptions, template: BAParams,
                   chunk_size: int = 8192, impl: str = "auto",
                   band_widths: tuple = (0, 0),
                   band_blocks: tuple = (0, 0),
                   band_intr_frozen: bool = False, pxm=None,
                   reducer=None, fuse_trial: bool = False):
    """LM step over the grid layout:
    step(state, grid, cam_free, point_free) -> (state, info).

    ``impl`` picks the linearize and the cost pass (the module's
    docstring); only the kernel path's E has a column order of its own,
    which the step meets by permuting C-sized vectors, never E.

    With ``reducer`` (``parallel.multihost.Reducer``), the step is one
    shard of a sharded step: the caller gives each rank its rows of the
    grid and of ``state.points``, and every sum over points (the camera
    system, the Schur pieces, the trust-region scalars, the trial cost)
    goes through the reducer, so all ranks hold the same camera update and
    take the same decisions. Without it: the single-device step.

    ``band_widths`` = (linearize, cost) live-band widths or width groups
    from ``rig_band.band_grid`` ((0, 0) = monolithic kernels) and
    ``band_blocks`` the point-tile widths their start tables were built
    for; the grid must then carry the matching ``band`` tables. ``pxm`` is
    the monolithic kernels' plane stack of the grid the step is given
    (:func:`mono_stack`), handed to both kernels; without it each kernel
    call builds its own.

    ``fuse_trial=True`` returns the fused-trial step over a
    :class:`GridStateF` (:func:`init_grid_state_fused`): the state carries
    the system at its iterate and the trial evaluation is the linearize
    kernel at the trial iterate, so an accepted step needs no cost pass
    and a rejected one re-solves from the stored system. Its select of
    the next system writes into ``state.sys``'s buffers (one pass over E
    a step, and none more under the on-device driver, whose buffers they
    are): the step consumes its state's system."""
    kernels = _check_impl(impl)
    to_flat, to_nat = column_maps(
        template, kernels, kernels and band_intr_frozen
        and bool(band_widths[0]))
    allsum, allmax, allsum_sym = reductions(reducer)

    def linearize_at(points, cam_vec, grid, cam_free, point_free):
        """The system at (points, cam_vec), its camera side summed over
        the ranks (its cost is the rank's own)."""
        with span("deeparc.grid.linearize", device=True):
            params = _params_from(cam_vec, points, template)
            sys = assemble_grid_system(
                points, slot_params(params, grid), grid, cam_free,
                point_free, chunk_size, options.loss, options.loss_scale,
                impl=impl, band_width=band_widths[0],
                band_block=band_blocks[0],
                band_intr_frozen=band_intr_frozen, pxm=pxm)
            if reducer is not None:
                sys = sys._replace(g_c=allsum(sys.g_c),
                                   hcc=allsum_sym(sys.hcc))
        return sys

    def solve_and_decide(sys, state, cam_free, point_free, trial_eval):
        """The LM core both steps share: solve the augmented system from
        ``sys``, evaluate the trial iterate with ``trial_eval(points, cam)
        -> (cost, payload)`` and take Ceres' accept and radius decision.
        Returns (accept, trial points, trial camera, payload, the next
        trust region, status, info)."""
        with span("deeparc.grid.schur", device=True):
            # augmented per-point blocks, eliminated in closed form, then
            # the reduced camera system S dc = rhs (the Schur complement)
            radius = state.tr.radius
            binv, d2c = schur_point_blocks(sys, radius, point_free, options)
            rhs, corr = schur_reduce(sys, binv, cam_free, to_flat, allsum,
                                     allsum_sym)
            dc = schur_cameras(sys, d2c, corr, rhs, radius, cam_free)
            e_dc, dp = schur_back(sys, binv, dc, point_free, to_nat)

            # model cost change from the stored quadratic pieces
            dtg = allsum(torch.sum(dp * sys.g_p)) + torch.dot(dc, sys.g_c)
            dhd = (allsum(torch.einsum("pi,pij,pj->", dp, sys.hpp, dp)
                          + 2.0 * torch.sum(dp * e_dc))
                   + dc @ (sys.hcc @ dc))
            mcc = -(dtg + 0.5 * dhd)

            new_points = state.points + dp
            new_cam = state.cam_vec + dc
        with span("deeparc.grid.trial_cost", device=True):
            new_cost, payload = trial_eval(new_points, new_cam)

        grad_max = torch.maximum(torch.max(torch.abs(sys.g_c)),
                                 allmax(torch.max(torch.abs(sys.g_p))))
        step_norm = torch.sqrt(allsum(torch.sum(dp * dp))
                               + torch.dot(dc, dc))
        x_norm = torch.sqrt(allsum(torch.sum(state.points * state.points))
                            + torch.dot(state.cam_vec, state.cam_vec))
        accept, tr_next, status, info = tr_mod.decide(
            state.cost, new_cost, mcc, state.tr, grad_max, step_norm, x_norm,
            options)
        return accept, new_points, new_cam, payload, tr_next, status, info

    def step(state: GridState, grid: GridIndex, cam_free, point_free):
        sys = linearize_at(state.points, state.cam_vec, grid, cam_free,
                           point_free)

        def trial_cost(points, cam_vec):
            trial = _params_from(cam_vec, points, template)
            return allsum(grid_cost(
                points, slot_params(trial, grid), grid, loss=options.loss,
                loss_scale=options.loss_scale, impl=impl,
                band_width=band_widths[1], band_block=band_blocks[1],
                pxm=pxm)), None

        accept, new_points, new_cam, _, tr_next, status, info = \
            solve_and_decide(sys, state, cam_free, point_free, trial_cost)
        next_state = GridState(
            points=torch.where(accept, new_points, state.points),
            cam_vec=torch.where(accept, new_cam, state.cam_vec),
            cost=info.cost, tr=tr_next, k=state.k + 1, status=status)
        return next_state, info

    def step_fused(state: GridStateF, grid: GridIndex, cam_free,
                   point_free):
        def trial_system(points, cam_vec):
            sys = linearize_at(points, cam_vec, grid, cam_free, point_free)
            cost = allsum(sys.cost)
            return cost, sys._replace(cost=cost)

        accept, new_points, new_cam, sys_trial, tr_next, status, info = \
            solve_and_decide(state.sys, state, cam_free, point_free,
                             trial_system)
        # the next system: the trial's where the step was accepted, the
        # stored one where not, written over the stored one
        sys_next = GridSystem(*(torch.where(accept, t, s, out=s)
                                for t, s in zip(sys_trial, state.sys)))
        next_state = GridStateF(
            points=torch.where(accept, new_points, state.points),
            cam_vec=torch.where(accept, new_cam, state.cam_vec),
            cost=info.cost, sys=sys_next, tr=tr_next, k=state.k + 1,
            status=status)
        return next_state, info

    return step_fused if fuse_trial else step


def init_grid_state(params: BAParams, grid: GridIndex, options: SolverOptions,
                    impl: str = "auto", band_widths: tuple = (0, 0),
                    band_blocks: tuple = (0, 0), pxm=None,
                    reducer=None) -> GridState:
    """The start state. ``impl`` must be the step's: the start cost comes
    from the same cost pass as every trial cost, so a borderline
    first-step rho cannot flip on rounding; with ``reducer`` it is summed
    over the ranks' rows, as in the step."""
    dtype, dev = params.points.dtype, params.points.device
    cost0 = grid_cost(params.points, slot_params(params, grid), grid,
                      loss=options.loss, loss_scale=options.loss_scale,
                      impl=impl, band_width=band_widths[1],
                      band_block=band_blocks[1], pxm=pxm)
    if reducer is not None:
        cost0 = reducer.sum(cost0)
    return GridState(points=params.points, cam_vec=flatten_camera(params),
                     cost=cost0,
                     tr=tr_mod.init_tr(options.initial_radius, dtype, dev),
                     k=0, status=torch.zeros((), dtype=torch.int64,
                                             device=dev))


def init_grid_state_fused(params: BAParams, grid: GridIndex,
                          options: SolverOptions, cam_free, point_free,
                          chunk_size: int = 8192, impl: str = "auto",
                          band_widths: tuple = (0, 0),
                          band_blocks: tuple = (0, 0),
                          band_intr_frozen: bool = False, pxm=None,
                          reducer=None) -> GridStateF:
    """The fused-trial step's start state: one linearize at the start
    iterate, whose cost doubles as the start cost (the same linearize as
    every trial evaluation; ``impl`` must be the step's); with ``reducer``
    its camera side and cost are summed over the ranks' rows, as in the
    step."""
    dtype, dev = params.points.dtype, params.points.device
    sys = assemble_grid_system(
        params.points, slot_params(params, grid), grid, cam_free, point_free,
        chunk_size, options.loss, options.loss_scale, impl=impl,
        band_width=band_widths[0], band_block=band_blocks[0],
        band_intr_frozen=band_intr_frozen, pxm=pxm)
    if reducer is not None:
        sys = sys._replace(g_c=reducer.sum(sys.g_c),
                           hcc=reducer.sum_sym(sys.hcc),
                           cost=reducer.sum(sys.cost))
    return GridStateF(points=params.points, cam_vec=flatten_camera(params),
                      cost=sys.cost.clone(), sys=sys,
                      tr=tr_mod.init_tr(options.initial_radius, dtype, dev),
                      k=0, status=torch.zeros((), dtype=torch.int64,
                                              device=dev))


def mono_stack(grid: GridIndex, block_nps: tuple) -> torch.Tensor:
    """The monolithic kernels' plane stack of ``grid``
    (``kernels.rig_grid.mono_planes``), padded to a point count that both
    kernels' tiles divide, so the linearize and the cost pass share it.
    It depends on the mask: a solve builds it once and drops it."""
    from deeparc_tpu_torch.kernels.rig_grid import mono_planes

    step = int(np.lcm.reduce(block_nps))
    return mono_planes(grid, -(-grid.xy0.shape[0] // step) * step)


def _strip_planes(prep):
    """The prep without its plane stacks (``band_grid_update`` gathers
    them again), so a stored prep holds no stale copy of the planes."""
    g = dataclasses.replace(prep.grid, band=prep.grid.band[:2])
    return prep._replace(grid=g)


@traced("deeparc.solve")
def solve_ba_grid(params: BAParams, grid: GridIndex, free: BAParams,
                  options: SolverOptions = SolverOptions(),
                  chunk_size: int = 8192,
                  checkpoint_path: str | None = None,
                  checkpoint_every: int = 10, resume: bool = False,
                  logger=None,
                  band_reuse: dict | None = None,
                  driver: str = "python",
                  while_block: int = 10,
                  fuse_trial: bool | None = None,
                  impl: str = "auto",
                  band: str = "auto") -> BAResult:
    """LM to convergence on the grid engine, through ``impl``'s linearize
    and cost pass (the module's docstring).

    ``driver="python"``: one Python-driven step per iteration with
    Ceres-style progress lines and the wall-clock cap (``src/sfm.cc:71``),
    a solver-state checkpoint every ``checkpoint_every`` iterations (points
    in their original order; ``resume=True`` restarts from
    ``checkpoint_path`` with the saved trust-region state) and a
    ``JsonlLogger``. ``driver="while_loop"``: blocks of up to
    ``while_block`` steps with no host read inside a block (on the card
    one CUDA graph, ``solver/device_loop.py``); the host applies the
    wall-clock cap and writes the checkpoint (when ``checkpoint_path`` is
    given) between blocks, and prints and logs nothing per iteration.

    On the kernel path with ``band="auto"`` the live-band prep
    (``solver/rig_band.py``) runs first; when it finds locality the solve
    takes the banded kernels (points are permuted internally and returned
    in their original order), otherwise the monolithic ones, which
    ``band="none"`` always takes. ``band_reuse`` is a caller-held dict
    that carries the prep across the pipeline's solve/filter rounds (the
    filter only removes observations, so the stored covers stay valid).
    The torch paths run no band prep.

    ``fuse_trial=True`` solves with the fused-trial step
    (``make_grid_step(fuse_trial=True)``: the linearize at the trial
    iterate is the trial evaluation, its system kept for the next step),
    under either driver; a resume linearizes at the checkpoint's iterate.
    ``None`` takes it off the kernels only, as the reference does: on the
    kernel path the select of the whole system costs more than the cost
    kernel it saves (measured on the TPU and again on the H100). A fused
    solve's costs
    come from the linearize, so it is close to a classic one, not
    bit-equal."""
    from deeparc_tpu_torch.solver.rig_band import (
        band_grid,
        band_grid_update,
    )

    check_driver(driver)
    if band not in ("auto", "none"):
        raise ValueError(f"unknown band {band!r}")
    kernels = _check_impl(impl)
    prep = None
    if band == "auto" and kernels:
        fresh = band_reuse is None or "prep" not in band_reuse
        with span("deeparc.grid.band_prep", fresh=int(fresh)) as sp:
            if fresh:
                prep = band_grid(grid)
                if band_reuse is not None:
                    band_reuse["prep"] = (None if prep is None
                                          else _strip_planes(prep))
            else:
                stored = band_reuse["prep"]
                prep = (None if stored is None
                        else band_grid_update(stored, grid))
            sp.set(w_band=0 if prep is None else prep.w_band)
    band_widths = band_blocks = (0, 0)
    intr_frozen = False
    unperm = lambda pts: pts
    # the monolithic kernels' stack of THIS solve's mask (a filter round's
    # next solve builds its own), in tiles of the linearize's points and of
    # the cost pass's 1024 (grid_cost's block)
    pxm = None
    if prep is None:
        with span("deeparc.grid.mono_stack"):
            pxm = mono_stack(grid, (min(chunk_size, 256), 1024))
    if prep is not None:
        if options.progress_to_stdout:
            print(f"[grid] live-band solve: w_band<={prep.w_band} of "
                  f"{grid.mask.shape[1]} cells, lin groups "
                  f"{[g[0] for g in prep.lin_groups]} "
                  f"(cost pass <={prep.w_band_cost}, groups "
                  f"{[g[0] for g in prep.cost_groups]})")
        grid = prep.grid
        perm, inv = prep.perm.long(), prep.inv.long()
        params = dataclasses.replace(params, points=params.points[perm])
        free = dataclasses.replace(free, points=free.points[perm])
        unperm = lambda pts: pts[inv]
        band_widths, band_blocks = prep.widths
        # all intrinsic columns frozen -> ext-only E (src/sfm.cc:60-62 is
        # the reference's standard BA mode)
        n_ext_rows = params.ext_rot.shape[0]
        intr_frozen = not bool(torch.any(
            flatten_camera(free)[6 * n_ext_rows:] != 0))

    with span("deeparc.grid.step_build"):
        cam_free = flatten_camera(free)
        point_free = free.points
        if fuse_trial is None:
            fuse_trial = not kernels
        step = make_grid_step(options, params, chunk_size, impl=impl,
                              band_widths=band_widths,
                              band_blocks=band_blocks,
                              band_intr_frozen=intr_frozen, pxm=pxm,
                              fuse_trial=fuse_trial)

    def init(p: BAParams):
        if fuse_trial:
            return init_grid_state_fused(
                p, grid, options, cam_free, point_free, chunk_size, impl,
                band_widths=band_widths, band_blocks=band_blocks,
                band_intr_frozen=intr_frozen, pxm=pxm)
        return init_grid_state(p, grid, options, impl,
                               band_widths=band_widths,
                               band_blocks=band_blocks, pxm=pxm)

    with span("deeparc.grid.init"):
        state = init(params)
        ck = load_checkpoint(checkpoint_path, resume, params)
        if ck is not None:
            # checkpoints hold points in ORIGINAL order
            ck_params, scal = ck
            if prep is not None:
                ck_params = dataclasses.replace(
                    ck_params, points=ck_params.points[perm])
            state = init(ck_params)._replace(tr=tr_of(scal, params.points),
                                             k=scal["iteration"])
    engine = "grid (fused trial)" if fuse_trial else "grid"
    original = lambda st: _params_from(st.cam_vec, unperm(st.points), params)
    if driver == "while_loop":
        from deeparc_tpu_torch.solver.device_loop import (
            BlockLoop,
            solve_blocks,
        )

        return solve_blocks(
            BlockLoop(step, (grid, cam_free, point_free)), state, options,
            while_block, checkpoint_path, original, engine=engine)
    state, k, _, t0 = run_steps(
        step, (grid, cam_free, point_free), state, options, engine=engine,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        original=original, logger=logger)
    with span("deeparc.grid.unpermute"):
        out_params = original(state)
        cost = float(state.cost)
    return BAResult(params=out_params, cost=cost, iterations=k,
                    status=int(state.status), seconds=time.time() - t0)


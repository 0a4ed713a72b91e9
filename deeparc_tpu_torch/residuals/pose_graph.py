"""Pose-graph residuals and refinement, PyTorch port of
``deeparc_tpu.residuals.pose_graph`` (the incremental engine's stage
between batches; the reference has no pose graph).

Poses are world->camera transforms (angle-axis w, translation t, the scene
extrinsics' parameterization); an edge (i, j) carries a measured relative
transform T_ij = T_i o T_j^-1, and its residual is the 6-dof log of the
discrepancy:

    R_rel = R_i R_j^T                  t_rel = t_i - R_rel t_j
    r_rot = log(R_meas^T R_rel)        r_t   = t_rel - t_meas

An edge's residual depends on its two poses only, so the refinement
(:func:`pose_graph_lm`) forms the normal equations of the free poses
directly: each edge's 6 x 12 Jacobian block by forward-mode AD, its four
6 x 6 products summed into the blocks of J^T J and its two 6-rows into
J^T r, in one fixed order (``kernels.tile.sum_rows``), then one Cholesky
solve with the LM diagonal a step. No (6L, 6P) Jacobian is formed: a BAL
scene of 1,778 cameras has ~2e5 edges, and that Jacobian would hold ~1e11
numbers. Each step takes Ceres' decision through ``trust_region.decide``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeparc_tpu_torch.geometry.rotation import (
    angle_axis_to_matrix,
    matrix_to_angle_axis,
)

# a pose's sources in the fixed-order sums are cut into segments of this
# many edges (a camera of a BAL scene may have ~1,800)
_SEGMENT = 512


class PoseGraph(NamedTuple):
    edges: torch.Tensor       # (L, 2) int (i, j)
    meas_rot: torch.Tensor    # (L, 3) angle-axis of the measured T_ij
    meas_trans: torch.Tensor  # (L, 3)
    weight_rot: float = 1.0
    weight_trans: float = 1.0


def relative_pose(rot_i, trans_i, rot_j, trans_j):
    """T_ij = T_i o T_j^-1 as (angle-axis, translation); batched."""
    R_i = angle_axis_to_matrix(rot_i)
    R_j = angle_axis_to_matrix(rot_j)
    R_rel = torch.einsum("...ab,...cb->...ac", R_i, R_j)      # R_i R_j^T
    t_rel = trans_i - torch.einsum("...ab,...b->...a", R_rel, trans_j)
    return matrix_to_angle_axis(R_rel), t_rel


def _edge_residuals(pose_i, pose_j, R_meas, meas_trans, weight_rot,
                    weight_trans):
    """(..., 3) rotation and (..., 3) translation residuals of edges whose
    end poses are ``pose_i``, ``pose_j`` (..., 6)."""
    R_i = angle_axis_to_matrix(pose_i[..., :3])
    R_j = angle_axis_to_matrix(pose_j[..., :3])
    R_rel = torch.einsum("...ab,...cb->...ac", R_i, R_j)
    t_rel = pose_i[..., 3:] - torch.einsum("...ab,...b->...a", R_rel,
                                           pose_j[..., 3:])
    R_err = torch.einsum("...ba,...bc->...ac", R_meas, R_rel)
    return (matrix_to_angle_axis(R_err) * weight_rot,
            (t_rel - meas_trans) * weight_trans)


def pose_graph_residuals(x: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """Flat residual vector for LM: x is (P, 6) poses flattened to (6P,)."""
    poses = x.reshape(-1, 6)
    i, j = graph.edges[:, 0].long(), graph.edges[:, 1].long()
    r_rot, r_t = _edge_residuals(poses[i], poses[j],
                                 angle_axis_to_matrix(graph.meas_rot),
                                 graph.meas_trans, graph.weight_rot,
                                 graph.weight_trans)
    return torch.cat([r_rot.reshape(-1), r_t.reshape(-1)])


def _edge_jacobians(poses: torch.Tensor, graph: PoseGraph,
                    R_meas: torch.Tensor) -> tuple:
    """(r (L, 6), J (L, 6, 12)): each edge's residual [rotation,
    translation] and its Jacobian by [pose_i, pose_j], by forward-mode AD
    of the one edge's residual, vmapped over the edges."""
    i, j = graph.edges[:, 0].long(), graph.edges[:, 1].long()
    wr, wt = graph.weight_rot, graph.weight_trans

    def one(x12, Rm, tm):
        r = torch.cat(_edge_residuals(x12[:6], x12[6:], Rm, tm, wr, wt))
        return r, r

    x12 = torch.cat([poses[i], poses[j]], dim=1)
    J, r = torch.func.vmap(torch.func.jacfwd(one, has_aux=True))(
        x12, R_meas, graph.meas_trans)
    return r, J


class _Blocks(NamedTuple):
    """Where an edge's products go in the free poses' system: its four
    6 x 6 blocks (ii, jj, ij, ji) among the F x F blocks of J^T J and its
    two 6-rows (i, j) among the F rows of J^T r, an anchored pose's to a
    spare last row; with the fixed-order maps of both sums."""

    F: int
    free_rows: torch.Tensor   # (F,) the free poses' ids
    hmap: tuple
    hdst: torch.Tensor        # (4L,)
    gmap: tuple
    gdst: torch.Tensor        # (2L,)


def _blocks(graph: PoseGraph, anchor: torch.Tensor) -> _Blocks:
    from deeparc_tpu_torch.kernels.tile import gather_map

    P = anchor.shape[0]
    free = ~anchor.to(torch.bool)
    free_rows = free.nonzero()[:, 0]
    F = int(free_rows.shape[0])
    fid = torch.full((P,), F, dtype=torch.long, device=anchor.device)
    fid[free_rows] = torch.arange(F, device=anchor.device)
    fi, fj = fid[graph.edges[:, 0].long()], fid[graph.edges[:, 1].long()]
    spare = F * F

    def block(a, b):
        return torch.where((a < F) & (b < F), a * F + b, spare)

    hdst = torch.cat([block(fi, fi), block(fj, fj), block(fi, fj),
                      block(fj, fi)])
    gdst = torch.cat([fi, fj])
    return _Blocks(F, free_rows, gather_map(hdst, spare + 1, _SEGMENT), hdst,
                   gather_map(gdst, F + 1, _SEGMENT), gdst)


def _normal_equations(r, J, blk: _Blocks) -> tuple:
    """(H (6F, 6F), g (F, 6)) = J^T J and J^T r over the free poses, each
    a sum in one fixed order (``kernels.tile.sum_rows``)."""
    from deeparc_tpu_torch.kernels.tile import sum_rows

    F = blk.F
    Ji, Jj = J[:, :, :6], J[:, :, 6:]
    prod = lambda a, b: torch.einsum("lki,lkj->lij", a, b).reshape(-1, 36)
    parts = torch.cat([prod(Ji, Ji), prod(Jj, Jj), prod(Ji, Jj),
                       prod(Jj, Ji)])
    H = sum_rows(parts, blk.hdst, F * F + 1, blk.hmap)[:F * F]
    H = H.reshape(F, F, 6, 6).permute(0, 2, 1, 3).reshape(6 * F, 6 * F)
    grad = torch.cat([torch.einsum("lki,lk->li", Ji, r),
                      torch.einsum("lki,lk->li", Jj, r)])
    g = sum_rows(grad, blk.gdst, F + 1, blk.gmap)[:F]
    return H, g


def pose_graph_lm(poses0: torch.Tensor, graph: PoseGraph,
                  anchor: torch.Tensor, options):
    """Levenberg-Marquardt over the (P, 6) poses, rows where ``anchor`` is
    True held (the gauge): each step solves (J^T J + D / radius) dx =
    -J^T r over the free poses, D the clamped diagonal of J^T J, and
    takes ``trust_region.decide``'s accept and stop, as
    ``solver.lm.levenberg_marquardt`` does on the dense Jacobian. Returns
    its ``LMResult`` (x the refined (P, 6) poses)."""
    from deeparc_tpu_torch.solver import trust_region as tr_mod
    from deeparc_tpu_torch.solver.linalg import spd_solve
    from deeparc_tpu_torch.solver.lm import LMResult

    R_meas = angle_axis_to_matrix(graph.meas_rot)
    blk = _blocks(graph, anchor)
    i, j = graph.edges[:, 0].long(), graph.edges[:, 1].long()

    def cost_of(x):
        r = torch.cat(_edge_residuals(x[i], x[j], R_meas, graph.meas_trans,
                                      graph.weight_rot, graph.weight_trans),
                      dim=1)
        return 0.5 * torch.sum(r * r)

    x = poses0
    cost = cost_of(x)
    tr = tr_mod.init_tr(options.initial_radius, x.dtype, x.device)
    k, status = 0, 0
    while status == 0 and k < options.max_iterations:
        r, J = _edge_jacobians(x, graph, R_meas)
        H, g = _normal_equations(r, J, blk)
        d2 = tr_mod.lm_diagonal(torch.diagonal(H), options.min_lm_diagonal,
                                options.max_lm_diagonal)
        H.diagonal().add_(d2 / tr.radius)
        dx_free = spd_solve(H, -g.reshape(-1)).reshape(-1, 6)
        dx = torch.zeros_like(x).index_copy_(0, blk.free_rows, dx_free)
        j_dx = (torch.einsum("lki,li->lk", J[:, :, :6], dx[i])
                + torch.einsum("lki,li->lk", J[:, :, 6:], dx[j]))
        mcc = tr_mod.model_cost_change(j_dx.reshape(-1), r.reshape(-1))
        x_new = x + dx
        new_cost = cost_of(x_new)
        grad_max = (torch.max(torch.abs(g)) if blk.F else
                    torch.zeros((), dtype=x.dtype, device=x.device))
        accept, tr, code, info = tr_mod.decide(
            cost, new_cost, mcc, tr, grad_max, torch.linalg.norm(dx),
            torch.linalg.norm(x), options)
        x = torch.where(accept, x_new, x)
        cost = info.cost
        k += 1
        status = int(code)
    return LMResult(x=x, cost=cost, iterations=k, status=status)


def solve_pose_graph(poses0: torch.Tensor, graph: PoseGraph,
                     anchor: torch.Tensor,
                     max_iterations: int = 100) -> torch.Tensor:
    """Refine (P, 6) poses; rows where ``anchor`` is True stay fixed (the
    gauge). Returns the refined (P, 6) poses (:func:`pose_graph_lm`)."""
    from deeparc_tpu_torch.config import SolverOptions

    return pose_graph_lm(poses0, graph, anchor,
                         SolverOptions(max_iterations=max_iterations)).x

"""Pose-graph residuals and refinement, PyTorch port of
``deeparc_tpu.residuals.pose_graph`` (the incremental engine's stage
between batches; the reference has no pose graph).

Poses are world->camera transforms (angle-axis w, translation t, the scene
extrinsics' parameterization); an edge (i, j) carries a measured relative
transform T_ij = T_i o T_j^-1, and its residual is the 6-dof log of the
discrepancy:

    R_rel = R_i R_j^T                  t_rel = t_i - R_rel t_j
    r_rot = log(R_meas^T R_rel)        r_t   = t_rel - t_meas

batched over edges and minimized by the dense LM (``solver/lm.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeparc_tpu_torch.geometry.rotation import (
    angle_axis_to_matrix,
    matrix_to_angle_axis,
)


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


def pose_graph_residuals(x: torch.Tensor, graph: PoseGraph) -> torch.Tensor:
    """Flat residual vector for LM: x is (P, 6) poses flattened to (6P,)."""
    poses = x.reshape(-1, 6)
    rot, trans = poses[:, :3], poses[:, 3:]
    i, j = graph.edges[:, 0].long(), graph.edges[:, 1].long()
    R_i = angle_axis_to_matrix(rot[i])
    R_j = angle_axis_to_matrix(rot[j])
    R_rel = torch.einsum("lab,lcb->lac", R_i, R_j)
    t_rel = trans[i] - torch.einsum("lab,lb->la", R_rel, trans[j])
    R_meas = angle_axis_to_matrix(graph.meas_rot)
    R_err = torch.einsum("lba,lbc->lac", R_meas, R_rel)       # R_meas^T R_rel
    r_rot = matrix_to_angle_axis(R_err) * graph.weight_rot
    r_t = (t_rel - graph.meas_trans) * graph.weight_trans
    return torch.cat([r_rot.reshape(-1), r_t.reshape(-1)])


def solve_pose_graph(poses0: torch.Tensor, graph: PoseGraph,
                     anchor: torch.Tensor,
                     max_iterations: int = 100) -> torch.Tensor:
    """Refine (P, 6) poses; rows where ``anchor`` is True stay fixed (the
    gauge). Returns the refined (P, 6) poses. The dense LM's Jacobian is
    (6L, 6P): pose graphs hold one pose per camera."""
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.solver.lm import levenberg_marquardt

    free = torch.repeat_interleave(1.0 - anchor.to(poses0.dtype), 6)
    result = levenberg_marquardt(pose_graph_residuals, poses0.reshape(-1),
                                 SolverOptions(max_iterations=max_iterations),
                                 free, graph)
    return result.x.reshape(-1, 6)

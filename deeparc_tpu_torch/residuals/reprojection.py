"""Batched reprojection residuals over the flat scene and the flattened
camera-vector layout, PyTorch port of the parts of
``deeparc_tpu.residuals.reprojection`` the grid pipeline uses.

Flattened camera vector (the reduced camera system's coordinates): per
extrinsic row e, cols [6e, 6e+3) = rot and [6e+3, 6e+6) = t; then per
intrinsic k, cols 6*(E+1) + 6k + {0,1} = center, {2,3} = focal, {4,5} = dist.
"""

from __future__ import annotations

import torch

from deeparc_tpu_torch.geometry.projection import (
    CameraSlice,
    StructureMasks,
    project_observation,
)
from deeparc_tpu_torch.scene import BAParams, SceneIndex


def gather_slices(params: BAParams, index: SceneIndex):
    """Per-observation parameter slices + structure masks."""
    op, oo = index.obs_point.long(), index.obs_outer.long()
    oi, ok = index.obs_inner.long(), index.obs_intr.long()
    cam = CameraSlice(
        point=params.points[op], center=params.center[ok],
        focal=params.focal[ok], dist=params.dist[ok],
        rot_outer=params.ext_rot[oo], t_outer=params.ext_trans[oo],
        rot_inner=params.ext_rot[oi], t_inner=params.ext_trans[oi],
    )
    masks = StructureMasks(focal_shared=index.focal_shared[ok],
                           dist_m1=index.dist_m1[ok],
                           dist_m2=index.dist_m2[ok])
    return cam, masks


def residuals(params: BAParams, index: SceneIndex) -> torch.Tensor:
    """Masked residuals (M, 2); dead observations contribute exactly zero."""
    cam, masks = gather_slices(params, index)
    r = project_observation(cam, masks, index.obs_xy)
    return r * index.obs_mask[:, None]


def cost(params: BAParams, index: SceneIndex) -> torch.Tensor:
    """0.5 * sum of squared residuals (Ceres' cost convention)."""
    r = residuals(params, index)
    return 0.5 * torch.sum(r * r)


def flatten_camera(params: BAParams) -> torch.Tensor:
    ext = torch.cat([params.ext_rot, params.ext_trans], dim=1)
    intr = torch.cat([params.center, params.focal, params.dist], dim=1)
    return torch.cat([ext.reshape(-1), intr.reshape(-1)])


def unflatten_camera(vec: torch.Tensor, template: BAParams) -> BAParams:
    n_ext_rows = template.ext_rot.shape[0]
    n_intr = template.center.shape[0]
    ext = vec[: 6 * n_ext_rows].reshape(n_ext_rows, 6)
    intr = vec[6 * n_ext_rows:].reshape(n_intr, 6)
    return BAParams(points=template.points, ext_rot=ext[:, 0:3],
                    ext_trans=ext[:, 3:6], center=intr[:, 0:2],
                    focal=intr[:, 2:4], dist=intr[:, 4:6])

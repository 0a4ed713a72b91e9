"""Batched reprojection residuals and Jacobian blocks over the flat scene,
and the flattened camera-vector layout, PyTorch port of
``deeparc_tpu.residuals.reprojection``.

The indexed engine's Jacobian is Ceres' forward-mode autodiff through the
residual functor (``src/snavely_reprojection_error.hh:94-118``) batched
over every observation: one ``torch.func.vmap(torch.func.jacfwd(...))``
over :func:`project_observation` gives the dense per-observation blocks

    J_point  (M, 2, 3)   d residual / d point3d
    J_cam    (M, 2, 18)  d residual / d [rot_o, t_o, rot_i, t_i,
                                         center, focal, dist]

(flat: (M, 6) columns r*3+i and (M, 36) columns r*18+c), which the
Schur solver (``solver/schur.py``) consumes with the camera columns
:func:`camera_col_indices` into the flattened camera vector.

Flattened camera vector (the reduced camera system's coordinates): per
extrinsic row e, cols [6e, 6e+3) = rot and [6e+3, 6e+6) = t; then per
intrinsic k, cols 6*(E+1) + 6k + {0,1} = center, {2,3} = focal, {4,5} = dist.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeparc_tpu_torch.geometry.projection import (
    CameraSlice,
    StructureMasks,
    project_observation,
)
from deeparc_tpu_torch.scene import BAParams, SceneIndex
from deeparc_tpu_torch.utils import debug

# Per-observation camera-side parameter count: rot_outer(3) + t_outer(3) +
# rot_inner(3) + t_inner(3) + center(2) + focal(2) + dist(2); structure
# masks zero the absent slots.
OBS_CAM_DIM = 18
# observations one vmap(jacfwd) call evaluates (bounds its temporaries)
JACOBIAN_CHUNK = 262_144


class ObsJacobians(NamedTuple):
    r: torch.Tensor        # (M, 2) masked residuals
    j_point: torch.Tensor  # (M, 2, 3)
    j_cam: torch.Tensor    # (M, 2, 18)


class FlatObsJacobians(NamedTuple):
    r: torch.Tensor   # (M, 2) masked residuals
    jp: torch.Tensor  # (M, 6)  d res / d point, columns r*3+i
    jc: torch.Tensor  # (M, 36) d res / d camera, columns r*18+c


def gather_slices(params: BAParams, index: SceneIndex, rows=None):
    """Per-observation parameter slices + structure masks (of the
    observations ``rows``, a slice, or all)."""
    rows = slice(None) if rows is None else rows
    op, oo = index.obs_point[rows].long(), index.obs_outer[rows].long()
    oi, ok = index.obs_inner[rows].long(), index.obs_intr[rows].long()
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
    """Masked residuals (M, 2); dead observations contribute exactly zero.
    Under ``utils.debug.nan_debugging`` a NaN in them raises."""
    cam, masks = gather_slices(params, index)
    r = project_observation(cam, masks, index.obs_xy)
    r = r * index.obs_mask[:, None]
    if debug.enabled():
        debug.check_call(residuals, (params, index), r,
                         "reprojection.residuals")
    return r


def cost(params: BAParams, index: SceneIndex) -> torch.Tensor:
    """0.5 * sum of squared residuals (Ceres' cost convention); checked
    as :func:`residuals` is."""
    r = residuals(params, index)
    c = 0.5 * torch.sum(r * r)
    if debug.enabled():
        debug.check_call(cost, (params, index), c, "reprojection.cost")
    return c


def _obs_jacobian(cam_slice: CameraSlice, masks: StructureMasks,
                  xy: torch.Tensor):
    """One observation's residual (2,), point block (2, 3) and camera block
    (2, 18) by forward-mode AD; the primal evaluation is shared with the
    Jacobian pass. Free of in-place ops and host reads, so it vmaps."""
    def f(cs):
        r = project_observation(cs, masks, xy)
        return r, r

    jac, r = torch.func.jacfwd(f, has_aux=True)(cam_slice)
    j_cam = torch.cat([jac.rot_outer, jac.t_outer, jac.rot_inner,
                       jac.t_inner, jac.center, jac.focal, jac.dist], dim=-1)
    return r, jac.point, j_cam


_batched_jacobian = torch.func.vmap(_obs_jacobian)


def jacobian_blocks_flat(params: BAParams, index: SceneIndex,
                         chunk: int = JACOBIAN_CHUNK) -> FlatObsJacobians:
    """Masked residuals and Jacobian blocks in the flat rank-2 layout,
    evaluated ``chunk`` observations at a time, so the gathered parameter
    slices and the AD temporaries never exist at full M."""
    M = index.obs_point.shape[0]
    dtype, dev = params.points.dtype, params.points.device
    r = torch.empty((M, 2), dtype=dtype, device=dev)
    jp = torch.empty((M, 6), dtype=dtype, device=dev)
    jc = torch.empty((M, 36), dtype=dtype, device=dev)
    for lo in range(0, M, chunk):
        rows = slice(lo, min(lo + chunk, M))
        cam, masks = gather_slices(params, index, rows)
        rc, jpc, jcc = _batched_jacobian(cam, masks, index.obs_xy[rows])
        w = index.obs_mask[rows, None]
        n = rc.shape[0]
        r[rows] = rc * w
        jp[rows] = jpc.reshape(n, 6) * w
        jc[rows] = jcc.reshape(n, 36) * w
    return FlatObsJacobians(r=r, jp=jp, jc=jc)


def jacobian_blocks(params: BAParams, index: SceneIndex) -> ObsJacobians:
    """Residuals and per-observation Jacobian blocks in the autodiff layout
    ((M, 2, 3) / (M, 2, 18)); the same numbers as
    :func:`jacobian_blocks_flat`."""
    flat = jacobian_blocks_flat(params, index)
    M = flat.r.shape[0]
    return ObsJacobians(r=flat.r, j_point=flat.jp.reshape(M, 2, 3),
                        j_cam=flat.jc.reshape(M, 2, OBS_CAM_DIM))


# Flattened camera-vector layout (the Schur reduced camera system's
# coordinates): per extrinsic row e, cols [6e, 6e+3) = rot, [6e+3, 6e+6) = t;
# then per intrinsic k, cols 6*(E+1) + 6k + {0,1}=center, {2,3}=focal,
# {4,5}=dist.

def camera_dim(params: BAParams) -> int:
    return 6 * params.ext_rot.shape[0] + 6 * params.center.shape[0]


def camera_col_indices(index: SceneIndex, n_ext_rows: int) -> torch.Tensor:
    """Per-observation column indices (M, 18) into the flattened camera
    vector: [outer ext row | inner ext row | intrinsic], 6 each."""
    six = torch.arange(6, dtype=torch.int64, device=index.obs_outer.device)
    outer = index.obs_outer.long()[:, None] * 6 + six[None, :]
    inner = index.obs_inner.long()[:, None] * 6 + six[None, :]
    intr = 6 * n_ext_rows + index.obs_intr.long()[:, None] * 6 + six[None, :]
    return torch.cat([outer, inner, intr], dim=1)


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

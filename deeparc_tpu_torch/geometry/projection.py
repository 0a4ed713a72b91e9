"""The deeparc projection model (composed-extrinsic pinhole + radial
distortion), PyTorch port of ``deeparc_tpu.geometry.projection``.

    p  = R_outer @ (R_inner @ X + t_inner) + t_outer
    xp, yp = p.x / p.z, p.y / p.z
    fx = focal[0]; fy = focal_shared ? focal[0] : focal[1]
    d  = 1 + r2 * (dist[0]*m1 + dist[1]*m2*r2)
    residual = [fx, fy] * d * [xp, yp] + principal - observed

(reference ``src/snavely_reprojection_error.hh:38-118``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeparc_tpu_torch.geometry.rotation import angle_axis_rotate


class CameraSlice(NamedTuple):
    """Per-observation parameters: point(3), principal(2), focal(2),
    distortion(2), outer rot/trans(3+3), inner rot/trans(3+3)."""

    point: torch.Tensor
    center: torch.Tensor
    focal: torch.Tensor
    dist: torch.Tensor
    rot_outer: torch.Tensor
    t_outer: torch.Tensor
    rot_inner: torch.Tensor
    t_inner: torch.Tensor


class StructureMasks(NamedTuple):
    """Per-observation structure constants (focal sharing, distortion order)."""

    focal_shared: torch.Tensor
    dist_m1: torch.Tensor
    dist_m2: torch.Tensor


def transform_point(cam: CameraSlice) -> torch.Tensor:
    """Apply the (inner -> outer) extrinsic chain to the point."""
    p = angle_axis_rotate(cam.rot_inner, cam.point) + cam.t_inner
    return angle_axis_rotate(cam.rot_outer, p) + cam.t_outer


def project_observation(cam: CameraSlice, masks: StructureMasks,
                        observed_xy: torch.Tensor) -> torch.Tensor:
    """Reprojection residual (..., 2)."""
    p = transform_point(cam)
    xp = p[..., 0] / p[..., 2]
    yp = p[..., 1] / p[..., 2]
    fx = cam.focal[..., 0]
    fy = torch.where(masks.focal_shared > 0.5, cam.focal[..., 0],
                     cam.focal[..., 1])
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cam.dist[..., 0] * masks.dist_m1
                             + cam.dist[..., 1] * masks.dist_m2 * r2)
    pred = torch.stack([fx * distortion * xp + cam.center[..., 0],
                        fy * distortion * yp + cam.center[..., 1]], dim=-1)
    return pred - observed_xy

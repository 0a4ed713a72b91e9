"""Batched rotation math (angle-axis centric), PyTorch port of
``deeparc_tpu.geometry.rotation``.

Ceres' ``AngleAxisRotatePoint`` / ``AngleAxisToRotationMatrix`` (reference
``src/snavely_reprojection_error.hh:87``, ``src/Camera/Extrinsic.hh:14``)
and the SO(3) right Jacobian the grid engine's closed-form derivatives use.
All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch

# Angle below which the small-angle (first-order Taylor) branch is used.
_SMALL_THETA2 = 1e-24


def _skew(x, y, z):
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def angle_axis_rotate(aa: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate point(s) ``p`` by angle-axis vector(s) ``aa`` (Rodrigues).
    Shapes: aa (..., 3), p (..., 3) -> (..., 3), broadcasting on the left."""
    aa, p = torch.broadcast_tensors(aa, p)
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 < _SMALL_THETA2
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    w = aa / theta
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    w_dot_p = torch.sum(w * p, dim=-1, keepdim=True)
    large = (cos_t * p + sin_t * torch.linalg.cross(w, p)
             + (1.0 - cos_t) * w_dot_p * w)
    small_out = p + torch.linalg.cross(aa, p)
    return torch.where(small, small_out, large)


def angle_axis_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrix (..., 3, 3), R @ x == rotate(aa, x)."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 < _SMALL_THETA2
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    w = aa / theta
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    K = _skew(w[..., 0], w[..., 1], w[..., 2])
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    wwT = w[..., :, None] * w[..., None, :]
    large = c * eye + s * K + (1.0 - c) * wwT
    small_R = eye + _skew(aa[..., 0], aa[..., 1], aa[..., 2])
    return torch.where(small[..., None], small_R, large)


def cross_matrix(v: torch.Tensor) -> torch.Tensor:
    """[v]_x skew-symmetric matrix (..., 3) -> (..., 3, 3)."""
    return _skew(v[..., 0], v[..., 1], v[..., 2])


def so3_right_jacobian(aa: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r of SO(3) at angle-axis aa (..., 3) -> (..., 3, 3):
    J_r = I - (1-cos t)/t^2 [w]_x + (t - sin t)/t^3 [w]_x^2, with the
    t -> 0 Taylor limits 1/2 and 1/6."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]
    small = theta2 < 1e-12
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    c1 = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(t)) / t2)
    c2 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (t - torch.sin(t)) / (t2 * t))
    K = cross_matrix(aa)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    return eye - c1 * K + c2 * (K @ K)

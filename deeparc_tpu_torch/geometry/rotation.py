"""Batched rotation math (angle-axis centric), PyTorch port of
``deeparc_tpu.geometry.rotation``.

Ceres' ``AngleAxisRotatePoint`` / ``AngleAxisToRotationMatrix`` (reference
``src/snavely_reprojection_error.hh:87``, ``src/Camera/Extrinsic.hh:14``),
``RotationMatrixToAngleAxis`` / ``QuaternionToAngleAxis`` (the pose graph's
rotation log, reference load path ``src/DeepArcManager.cc:142,144``) and
the SO(3) right Jacobian the grid engine's closed-form derivatives use.
All functions broadcast over leading batch dimensions and pick their
branches with ``torch.where``, so they run under ``torch.func.vmap`` and
stay differentiable at angle 0 and near pi.
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


def matrix_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> angle-axis (..., 3), through the
    quaternion of Shepperd's method: the largest of (trace, R00, R11, R22)
    picks the branch, which keeps the result accurate near angle 0 and pi
    (``ceres::RotationMatrixToAngleAxis``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def case(tw, tx, ty, tz, s):
        return (torch.stack([tw, tx, ty, tz], dim=-1)
                / (2.0 * torch.sqrt(s)[..., None]))

    s0 = torch.clamp(1.0 + tr, min=1e-30)
    q0 = case(s0, m21 - m12, m02 - m20, m10 - m01, s0)
    s1 = torch.clamp(1.0 + m00 - m11 - m22, min=1e-30)
    q1 = case(m21 - m12, s1, m01 + m10, m02 + m20, s1)
    s2 = torch.clamp(1.0 - m00 + m11 - m22, min=1e-30)
    q2 = case(m02 - m20, m01 + m10, s2, m12 + m21, s2)
    s3 = torch.clamp(1.0 - m00 - m11 + m22, min=1e-30)
    q3 = case(m10 - m01, m02 + m20, m12 + m21, s3, s3)

    diag_max01 = torch.where((m00 > m11)[..., None], q1, q2)
    diag_max = torch.where((torch.maximum(m00, m11) > m22)[..., None],
                           diag_max01, q3)
    q = torch.where((tr > 0.0)[..., None], q0, diag_max)
    return quaternion_to_angle_axis(q)


def quaternion_to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) (..., 4) -> angle-axis (..., 3)
    (``ceres::QuaternionToAngleAxis``); w < 0 folds the angle into
    (-pi, 0] as Ceres does."""
    w = q[..., 0]
    xyz = q[..., 1:]
    sin_half2 = torch.sum(xyz * xyz, dim=-1)
    small = sin_half2 < _SMALL_THETA2
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(sin_half2),
                                      sin_half2))
    neg = w < 0.0
    two_theta = 2.0 * torch.atan2(torch.where(neg, -sin_half, sin_half),
                                  torch.where(neg, -w, w))
    # first order at angle 0: aa = 2 xyz
    k = torch.where(small, torch.full_like(two_theta, 2.0),
                    two_theta / sin_half)
    return xyz * k[..., None]

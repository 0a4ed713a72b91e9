"""Camera centers for single and composed (ring -> arc) extrinsics,
PyTorch port of ``deeparc_tpu.geometry.camera``
(reference ``src/DeepArcManager.cc:242-264,501-518``)."""

from __future__ import annotations

import torch

from deeparc_tpu_torch.geometry.rotation import angle_axis_to_matrix


def camera_center_single(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """c = -R^T t for angle-axis rot (..., 3), trans (..., 3) -> (..., 3)."""
    R = angle_axis_to_matrix(rot)
    return -torch.einsum("...ji,...j->...i", R, trans)


def camera_center_composed(rot_arc, t_arc, rot_ring, t_ring) -> torch.Tensor:
    """c = -R_ring^T t_ring - R_ring^T R_arc^T t_arc."""
    R_ring = angle_axis_to_matrix(rot_ring)
    R_arc = angle_axis_to_matrix(rot_arc)
    term1 = torch.einsum("...ji,...j->...i", R_ring, t_ring)
    rt_arc = torch.einsum("...ji,...j->...i", R_arc, t_arc)
    term2 = torch.einsum("...ji,...j->...i", R_ring, rt_arc)
    return -(term1 + term2)


def hemisphere_camera_centers(ext_rot: torch.Tensor, ext_trans: torch.Tensor,
                              arc_size: int, ring_size: int) -> torch.Tensor:
    """Centers for every (arc, ring) cell of a shared-extrinsic rig,
    (arc_size * ring_size, 3) in arc-major order: ring 0 -> single(arc),
    arc 0 -> single(ring), else composed(arc, ring)."""
    dev = ext_rot.device
    arc_idx = torch.arange(arc_size, device=dev).repeat_interleave(ring_size)
    ring_pos = torch.arange(ring_size, device=dev).repeat(arc_size)
    ring_idx = torch.where(ring_pos == 0, 0, ring_pos + arc_size - 1)
    rot_a, t_a = ext_rot[arc_idx], ext_trans[arc_idx]
    rot_r, t_r = ext_rot[ring_idx], ext_trans[ring_idx]
    single_arc = camera_center_single(rot_a, t_a)
    single_ring = camera_center_single(rot_r, t_r)
    composed = camera_center_composed(rot_a, t_a, rot_r, t_r)
    use_arc = (ring_pos == 0)[:, None]
    use_ring = ((arc_idx == 0) & (ring_pos != 0))[:, None]
    return torch.where(use_arc, single_arc,
                       torch.where(use_ring, single_ring, composed))

"""Grid-space outlier filtering (the reference's ``filterPoint3d``,
``src/DeepArcManager.cc:331-424``), PyTorch port of
``deeparc_tpu.pipeline.filtering.filter_masks_grid``: mask updates only.

  1. observations whose MSE (r0^2 + r1^2) / 2 crosses ``error_boundary``
     die (direction explicit, ``parity_inverted`` for the literal
     reference comparison, cc:347-349);
  2. points left with no live observation die (cc:368-378);
  3. points farther than hemisphere_radius / 2 in SQUARED distance from the
     hemisphere center die, with their observations (cc:380-408).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeparc_tpu_torch.config import FilterOptions


class FilterStats(NamedTuple):
    obs_alive: torch.Tensor
    points_alive: torch.Tensor


def filter_masks_grid(params, grid, hemisphere_center: torch.Tensor,
                      hemisphere_radius,
                      options: FilterOptions = FilterOptions()):
    """Returns (grid_mask', point_mask') on the dense (points x cells) grid."""
    from deeparc_tpu_torch.solver.rig_grid import grid_residuals, slot_params

    r = grid_residuals(params.points, slot_params(params, grid), grid)
    mse = 0.5 * torch.sum(r * r, dim=-1)                  # (N, T)
    if options.parity_inverted:
        bad = (mse < options.error_boundary) & (grid.mask > 0.5)
    else:
        bad = mse > options.error_boundary
    mask = grid.mask * (1.0 - bad.to(grid.mask.dtype))
    point_mask = grid.point_mask * (torch.sum(mask, dim=1) > 0)
    if options.hemisphere_cut:
        d2 = torch.sum((params.points - hemisphere_center[None, :]) ** 2,
                       dim=-1)
        far = d2 > hemisphere_radius / 2.0
        point_mask = point_mask * (1.0 - far.to(point_mask.dtype))
    return mask * point_mask[:, None], point_mask

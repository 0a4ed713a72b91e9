"""Outlier filtering (the reference's ``filterPoint3d``,
``src/DeepArcManager.cc:331-424``) on the observation list, the grid and the
tile layout, PyTorch port of ``deeparc_tpu.pipeline.filtering``
(``filter_masks`` / ``filter_outliers``, ``filter_masks_grid``,
``filter_masks_tiles``): mask updates only; ``scene.compact`` drops the
dead entries between the indexed engine's solves.

  1. observations whose MSE (r0^2 + r1^2) / 2 crosses ``error_boundary``
     die (direction explicit, ``parity_inverted`` for the literal
     reference comparison, cc:347-349);
  2. points left with no live observation die (cc:368-378);
  3. points farther than hemisphere_radius / 2 in SQUARED distance from the
     hemisphere center die, with their observations (cc:380-408).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from deeparc_tpu_torch.config import FilterOptions


class FilterStats(NamedTuple):
    obs_alive: torch.Tensor
    points_alive: torch.Tensor


def filter_masks(params, index, hemisphere_center: torch.Tensor,
                 hemisphere_radius, options: FilterOptions = FilterOptions()):
    """Updated (obs_mask, point_mask) of the observation list."""
    from deeparc_tpu_torch.residuals.reprojection import residuals

    r = residuals(params, index)
    mse = 0.5 * torch.sum(r * r, dim=-1)
    if options.parity_inverted:
        # literal reference comparison, DeepArcManager.cc:348
        bad_obs = mse < options.error_boundary
    else:
        bad_obs = mse > options.error_boundary
    obs_mask = index.obs_mask * (1.0 - bad_obs.to(index.obs_mask.dtype))
    # live observations per point: a sum of 0/1 values, exact in any order
    live_counts = torch.zeros_like(index.point_mask).index_add_(
        0, index.obs_point.long(), obs_mask)
    point_mask = index.point_mask * (live_counts > 0)
    if options.hemisphere_cut:
        d2 = torch.sum((params.points - hemisphere_center[None, :]) ** 2,
                       dim=-1)
        far = d2 > hemisphere_radius / 2.0
        point_mask = point_mask * (1.0 - far.to(point_mask.dtype))
    # cascade: observations of dead points die (Point3d::total_link removal)
    obs_mask = obs_mask * point_mask[index.obs_point.long()]
    return obs_mask, point_mask


def filter_outliers(scene, hemisphere_center, hemisphere_radius,
                    options: FilterOptions = FilterOptions()):
    """The filter applied to a Scene: (scene with the new masks, stats)."""
    p = scene.params.points
    obs_mask, point_mask = filter_masks(
        scene.params, scene.index,
        torch.as_tensor(hemisphere_center, dtype=p.dtype, device=p.device),
        float(hemisphere_radius), options)
    index = dataclasses.replace(scene.index, obs_mask=obs_mask,
                                point_mask=point_mask)
    stats = FilterStats(obs_alive=int(obs_mask.sum()),
                        points_alive=int(point_mask.sum()))
    return dataclasses.replace(scene, index=index), stats


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


def filter_masks_tiles(points_t, params, tiles, hemisphere_center,
                       hemisphere_radius,
                       options: FilterOptions = FilterOptions()):
    """Tile-row-space filterPoint3d: returns (new mask planes, row_mask).

    The same three passes on the tile engine's bucket planes: per-slot MSE
    against ``error_boundary``, rows with no live slot die, the hemisphere
    distance cut with cascade to the row's slots. Shapes never change, so
    every round reuses the layout and its slot bins."""
    from deeparc_tpu_torch.solver.rig_grid import slot_params
    from deeparc_tpu_torch.solver.tiles import pack_cells, tile_mse_planes

    params_rows = dataclasses.replace(params, points=points_t)
    cam_ones = torch.ones(6 * params.ext_rot.shape[0]
                          + 6 * params.center.shape[0],
                          dtype=points_t.dtype, device=points_t.device)
    packed = pack_cells(slot_params(params_rows, tiles.cells), tiles.cells,
                        cam_ones)
    new_masks, live_rows = [], []
    for b, mse in zip(tiles.buckets, tile_mse_planes(points_t, packed, tiles)):
        if options.parity_inverted:
            bad = (mse < options.error_boundary) & (b.mask > 0.5)
        else:
            bad = mse > options.error_boundary
        m = b.mask * (1.0 - bad.to(b.mask.dtype))
        new_masks.append(m)
        live_rows.append(torch.sum(m, dim=1) > 0)
    tail = points_t.shape[0] - sum(m.shape[0] for m in new_masks)
    if tail > 0:
        live_rows.append(torch.zeros(tail, dtype=torch.bool,
                                     device=points_t.device))
    row_mask = torch.cat(live_rows).to(points_t.dtype)
    if options.hemisphere_cut:
        d2 = torch.sum((points_t - hemisphere_center[None, :]) ** 2, dim=-1)
        row_mask = row_mask * (1.0 - (d2 > hemisphere_radius / 2.0).to(
            row_mask.dtype))
    out, off = [], 0
    for m in new_masks:
        out.append(m * row_mask[off:off + m.shape[0], None])
        off += m.shape[0]
    return tuple(out), row_mask

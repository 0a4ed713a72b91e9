"""BFS-ordered incremental bundle adjustment, PyTorch port of
``deeparc_tpu.pipeline.incremental``.

Cameras are registered in batches, in breadth-first order over the
covisibility graph (the reference's ``*_bfs.deeparc`` datasets order their
observations so), and after each batch a structure-only solve (the
reference's freeze-camera pre-solve, ``src/sfm.cc:111``) and a full BA over
everything registered so far run. A shared rig runs on the grid engine,
where registering cameras turns on columns of the (points x cells)
visibility mask; a non-shared scene runs on the tile engine with a
pose-graph refinement between batches.

The BFS orders are numpy and equal the reference's integer for integer.

While a profiler records, :func:`run_incremental` opens the
``deeparc.incremental`` root (``utils/profiling.py``). On a shared rig it
holds ``.load``, ``.layout``, ``.order``, ``.band``, one ``.batch`` a
batch (counts ``batch``, ``active_cells``, ``live_points``) holding
``.mask``, ``.structure`` and ``.full``, then ``.final_cost``; the free
path has ``.load``, ``.order``, ``.structure``, ``.pose_graph``, ``.full``
and ``.final_cost``. The solves' own spans nest inside. Off, the spans do
nothing.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from deeparc_tpu_torch.config import PipelineOptions
from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.io import DeepArcData
from deeparc_tpu_torch.scene import _np, freeze_masks, from_deeparc
from deeparc_tpu_torch.utils.profiling import span, traced


class IncrementalResult(NamedTuple):
    scene: object
    batches: int
    order: np.ndarray        # BFS cell (camera) order
    final_cost: float
    final_rmse_px: float
    history: list            # per-batch dicts
    solve_seconds: float = 0.0   # wall clock of every solve's LM loop
    solve_iterations: int = 0    # LM iterations over every solve
    cg_iterations: int = 0       # PCG iterations over every solve


def bfs_cell_order_from_covis(covis: np.ndarray, start: int = 0,
                              n_cells: int | None = None) -> np.ndarray:
    """BFS over a (C, C) covisibility-count matrix, strongest neighbours
    first (stable order); returns a permutation of all ``n_cells`` (default
    C) cells, unreachable ones appended in index order."""
    C = covis.shape[0] if n_cells is None else n_cells
    seen = np.zeros(C, dtype=bool)
    order = []
    queue = [start]
    seen[start] = True
    while queue:
        c = queue.pop(0)
        order.append(c)
        neighbors = np.nonzero(covis[c] > 0)[0]
        neighbors = neighbors[np.argsort(-covis[c][neighbors], kind="stable")]
        for n in neighbors:
            if not seen[n]:
                seen[n] = True
                queue.append(int(n))
    order += [c for c in range(C) if not seen[c]]
    return np.asarray(order, dtype=np.int64)


def _covisibility(vis) -> np.ndarray:
    """(C, C) shared-point counts of a 0/1 (N, C) visibility matrix, its
    diagonal zeroed: one float64 product (on the matrix's device), exact
    for counts below 2**53."""
    vis = torch.as_tensor(vis).to(torch.float64)
    covis = (vis.T @ vis).cpu().numpy().astype(np.int64)
    np.fill_diagonal(covis, 0)
    return covis


def bfs_cell_order(mask, n_cells: int, start: int = 0) -> np.ndarray:
    """BFS over the cell covisibility graph (cells sharing >= 1 point) of
    the (N, T) visibility grid ``mask`` (an array or a tensor)."""
    return bfs_cell_order_from_covis(
        _covisibility(torch.as_tensor(mask) > 0.5), start, n_cells)


def _band_state(grid) -> dict:
    """The band prep of the FULL mask, handed to every batch's solves
    through ``band_reuse``: a batch's live observations are a subset of
    the full mask's, which ``band_grid_update`` accepts, so one prep (or
    the monolithic path, when ``band_grid`` declines) serves every batch."""
    from deeparc_tpu_torch.solver.rig_band import band_grid
    from deeparc_tpu_torch.solver.rig_grid import _strip_planes

    prep = band_grid(grid)
    return {"prep": None if prep is None else _strip_planes(prep)}


def _add(totals: dict, res) -> None:
    """Sum a solve's LM seconds and iterations into ``totals``."""
    totals["seconds"] += res.seconds
    totals["iterations"] += res.iterations
    totals["cg"] += res.cg_iterations


def _result(scene, n_batches, order, history, totals) -> IncrementalResult:
    from deeparc_tpu_torch.pipeline.driver import rmse_px

    with span("deeparc.incremental.final_cost"):
        final_rmse = rmse_px(scene)
    return IncrementalResult(
        scene=scene, batches=n_batches, order=order,
        final_cost=history[-1]["cost"] if history else 0.0,
        final_rmse_px=final_rmse, history=history,
        solve_seconds=totals["seconds"],
        solve_iterations=totals["iterations"], cg_iterations=totals["cg"])


@traced("deeparc.incremental")
def run_incremental(data: DeepArcData,
                    options: PipelineOptions = PipelineOptions(),
                    batch_size: int | None = None, dtype=torch.float64,
                    device="cuda", verbose: bool = True,
                    pose_graph: bool = True,
                    min_observations: int = 2) -> IncrementalResult:
    """Incremental BA over BFS-ordered cameras on ``device``.

    Shared rigs run on the grid engine: each batch turns on ``batch_size``
    more cells (default: one ring), then a structure-only solve on the
    newly visible points and a full BA over every active cell. A point is
    solved once ``min_observations`` of its observations are active: one
    observation fixes a ray, not a point, and a point freed on it slides
    along the ray (in an 8 x 24 rig of 400k points one went 2e6 scene
    units out, where later views no longer pull it back); 1 is the JAX
    package's rule on a rig. Non-shared scenes go to
    :func:`run_incremental_free` (two observations, as in the JAX package),
    with the pose-graph stage when ``pose_graph``; a shared rig's extrinsic
    records are coupled by the rig sharing, a stronger constraint than any
    pose graph."""
    if not data.share_extrinsic:
        return run_incremental_free(data, options, batch_size=batch_size,
                                    dtype=dtype, device=device,
                                    verbose=verbose, pose_graph=pose_graph)
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        solve_ba_grid,
    )

    log = print if verbose else (lambda *a, **k: None)
    with span("deeparc.incremental.load", obs=data.n_obs):
        scene = from_deeparc(data, dtype=dtype, device=check_device(device))
    with span("deeparc.incremental.layout"):
        grid = grid_from_scene(scene)
    T = grid.mask.shape[1]
    full_mask = grid.mask
    with span("deeparc.incremental.order"):
        order = bfs_cell_order(full_mask, T, start=0)
    if batch_size is None:
        batch_size = scene.meta.ring_size
    with span("deeparc.incremental.band"):
        band_state = _band_state(grid)

    active = np.zeros(T)
    history = []
    totals = {"seconds": 0.0, "iterations": 0, "cg": 0}
    params = scene.params
    n_batches = -(-T // batch_size)
    for b in range(n_batches):
        active[order[b * batch_size:(b + 1) * batch_size]] = 1.0
        with span("deeparc.incremental.batch", batch=b,
                  active_cells=int(active.sum())) as sp:
            with span("deeparc.incremental.mask"):
                mask = full_mask * torch.as_tensor(
                    active, dtype=full_mask.dtype,
                    device=full_mask.device)[None, :]
                masked_grid = dataclasses.replace(grid, mask=mask)
                scene_b = dataclasses.replace(scene, params=params)
                # points with too few active observations stay frozen
                live = (mask.sum(dim=1) >= min_observations).to(
                    params.points.dtype)[:, None]
                n_live = int(live.sum())
                free_structure = freeze_masks(scene_b, freeze_camera=True)
                free_structure = dataclasses.replace(
                    free_structure, points=free_structure.points * live)
                free_full = freeze_masks(scene_b)
                free_full = dataclasses.replace(
                    free_full, points=free_full.points * live)
            sp.set(live_points=n_live)

            with span("deeparc.incremental.structure"):
                res = solve_ba_grid(params, masked_grid, free_structure,
                                    options.solver, band_reuse=band_state)
            _add(totals, res)
            params, structure_iterations = res.params, res.iterations

            with span("deeparc.incremental.full"):
                res = solve_ba_grid(params, masked_grid, free_full,
                                    options.solver, band_reuse=band_state)
            _add(totals, res)
            params = res.params
        history.append({"batch": b, "active_cells": int(active.sum()),
                        "cost": float(res.cost),
                        "iterations": res.iterations,
                        "structure_iterations": structure_iterations,
                        "live_points": n_live})
        log(f"[incremental] batch {b + 1}/{n_batches}: "
            f"{int(active.sum())}/{T} cells, cost={res.cost:.6e}, "
            f"iters={res.iterations}")

    scene = dataclasses.replace(scene, params=params)
    return _result(scene, n_batches, order, history, totals)


def camera_covisibility(scene) -> np.ndarray:
    """(C, C) counts of shared points between cameras (non-shared scenes:
    camera == outer extrinsic record)."""
    obs_cam = _np(scene.index.obs_outer)
    obs_point = _np(scene.index.obs_point)
    alive = _np(scene.index.obs_mask) > 0.5
    vis = torch.zeros((scene.n_points, scene.n_extrinsics),
                      dtype=torch.float64, device=scene.index.obs_point.device)
    vis[torch.as_tensor(obs_point[alive], device=vis.device),
        torch.as_tensor(obs_cam[alive], device=vis.device)] = 1.0
    return _covisibility(vis)


def run_incremental_free(data: DeepArcData,
                         options: PipelineOptions = PipelineOptions(),
                         batch_size: int | None = None, dtype=torch.float64,
                         device="cuda", verbose: bool = True,
                         pose_graph: bool = True,
                         min_covis: int = 3) -> IncrementalResult:
    """Incremental BA for free-camera (non-shared) scenes on the tile
    engine, with pose-graph refinement between batches.

    When a camera pair first becomes covisible (>= ``min_covis`` shared
    points), the relative pose of the CURRENT estimates is kept as that
    edge's measurement. After each batch's structure-only solve, every
    registered pose is refined to agree with every kept measurement
    (camera record 0 and the unregistered cameras anchored, the gauge of
    ``src/sfm.cc:50-53``), then the full BA over the registered cameras
    runs (default batch: C // 8 cameras)."""
    from deeparc_tpu_torch.residuals.pose_graph import (
        PoseGraph,
        relative_pose,
        solve_pose_graph,
    )
    from deeparc_tpu_torch.solver.tiles import solve_ba_tiles

    log = print if verbose else (lambda *a, **k: None)
    device = check_device(device)
    with span("deeparc.incremental.load", obs=data.n_obs):
        scene = from_deeparc(data, dtype=dtype, device=device)
    if scene.meta.share_extrinsic:
        raise ValueError("run_incremental_free is the non-shared path")
    C = scene.n_extrinsics
    with span("deeparc.incremental.order"):
        covis = camera_covisibility(scene)
        order = bfs_cell_order_from_covis(covis)
    if batch_size is None:
        batch_size = max(C // 8, 1)

    obs_cam = _np(scene.index.obs_outer)
    obs_point = _np(scene.index.obs_point)
    full_obs_mask = _np(scene.index.obs_mask)
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                     device=device)

    active = np.zeros(C, dtype=bool)
    snapshots = {}          # edge (i, j) -> (meas_rot, meas_trans) at capture
    history = []
    totals = {"seconds": 0.0, "iterations": 0, "cg": 0}
    params = scene.params
    n_batches = -(-C // batch_size)
    for b in range(n_batches):
        active[order[b * batch_size:(b + 1) * batch_size]] = True

        # pose-graph measurements of the edges that just became active
        if pose_graph:
            act = np.nonzero(active)[0]
            ii, jj = np.meshgrid(act, act, indexing="ij")
            cand = (ii < jj) & (covis[ii, jj] >= min_covis)
            new_edges = [(int(i), int(j)) for i, j in zip(ii[cand], jj[cand])
                         if (int(i), int(j)) not in snapshots]
            if new_edges:
                e = torch.as_tensor(np.asarray(new_edges), device=device)
                mr, mt = relative_pose(
                    params.ext_rot[e[:, 0]], params.ext_trans[e[:, 0]],
                    params.ext_rot[e[:, 1]], params.ext_trans[e[:, 1]])
                mr, mt = _np(mr), _np(mt)
                for k, edge in enumerate(new_edges):
                    snapshots[edge] = (mr[k], mt[k])

        obs_mask_b = full_obs_mask * active[obs_cam]
        live_counts = np.bincount(obs_point[obs_mask_b > 0.5],
                                  minlength=scene.n_points)
        live = as_t(live_counts >= 2)[:, None]
        n_live = int(np.count_nonzero(live_counts >= 2))
        index_b = dataclasses.replace(scene.index, obs_mask=as_t(obs_mask_b))
        scene_b = dataclasses.replace(scene, params=params, index=index_b)
        # registered camera records; the identity slot stays frozen
        active_rows = as_t(np.concatenate([active.astype(float), [0.0]]))

        # structure-only pre-solve on the newly visible points (sfm.cc:111)
        free_structure = freeze_masks(scene_b, freeze_camera=True)
        free_structure = dataclasses.replace(
            free_structure, points=free_structure.points * live)
        with span("deeparc.incremental.structure"):
            res = solve_ba_tiles(scene_b, free_structure, options.solver)
        _add(totals, res)
        params, structure_iterations = res.params, res.iterations
        scene_b = dataclasses.replace(scene_b, params=params)

        # pose-graph refinement over the registered cameras
        if pose_graph and snapshots:
            edges = np.asarray(sorted(snapshots), dtype=np.int32)
            graph = PoseGraph(
                edges=torch.as_tensor(edges, device=device),
                meas_rot=as_t(np.stack([snapshots[tuple(e)][0]
                                        for e in edges])),
                meas_trans=as_t(np.stack([snapshots[tuple(e)][1]
                                          for e in edges])))
            poses0 = torch.cat([params.ext_rot[:C], params.ext_trans[:C]],
                               dim=1)
            anchor = torch.as_tensor((~active) | (np.arange(C) == 0),
                                     device=device)
            with span("deeparc.incremental.pose_graph"):
                refined = solve_pose_graph(poses0, graph, anchor,
                                           max_iterations=20)
            params = dataclasses.replace(
                params,
                ext_rot=torch.cat([refined[:, :3], params.ext_rot[C:]]),
                ext_trans=torch.cat([refined[:, 3:], params.ext_trans[C:]]))
            scene_b = dataclasses.replace(scene_b, params=params)

        # full BA over everything registered so far (the rest frozen)
        free_full = freeze_masks(scene_b)
        free_full = dataclasses.replace(
            free_full, points=free_full.points * live,
            ext_rot=free_full.ext_rot * active_rows[:, None],
            ext_trans=free_full.ext_trans * active_rows[:, None])
        with span("deeparc.incremental.full"):
            res = solve_ba_tiles(scene_b, free_full, options.solver)
        _add(totals, res)
        params = res.params
        history.append({"batch": b, "active_cells": int(active.sum()),
                        "cost": float(res.cost),
                        "iterations": res.iterations,
                        "structure_iterations": structure_iterations,
                        "live_points": n_live})
        log(f"[incremental-free] batch {b + 1}/{n_batches}: "
            f"{int(active.sum())}/{C} cameras, cost={res.cost:.6e}, "
            f"iters={res.iterations}")

    scene = dataclasses.replace(scene, params=params)
    return _result(scene, n_batches, order, history, totals)

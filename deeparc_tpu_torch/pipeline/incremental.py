"""BFS-ordered incremental bundle adjustment, PyTorch port of
``deeparc_tpu.pipeline.incremental``.

Cameras are registered in batches, in breadth-first order over the
covisibility graph (the reference's ``*_bfs.deeparc`` datasets order their
observations so), and after each batch a structure-only solve (the
reference's freeze-camera pre-solve, ``src/sfm.cc:111``) and a full BA over
everything registered so far run. A shared rig runs on the grid engine,
where registering cameras turns on columns of the (points x cells)
visibility mask; a non-shared scene runs on the tile engine, on one
layout of the whole scene whose mask planes each batch sets, with a
pose-graph refinement between batches.

The BFS orders are numpy and equal the reference's integer for integer.

While a profiler records, :func:`run_incremental` opens the
``deeparc.incremental`` root (``utils/profiling.py``). On a shared rig it
holds ``.load``, ``.layout``, ``.order``, ``.band``, one ``.batch`` a
batch (counts ``batch``, ``active_cells``, ``live_points``) holding
``.mask``, ``.structure`` and ``.full``, then ``.final_cost``. The free
path holds ``.load``, ``.layout`` (its one tile layout), ``.order``, one
``.batch`` a batch (counts ``batch``, ``active_cameras``, ``live_points``,
``edges``) holding ``.edges`` (the new pose-graph measurements), ``.mask``,
``.structure``, ``.pose_graph`` (CUDA events; counts ``edges`` and
``iterations``) and ``.full``, then ``.final_cost``. The solves' own spans
nest inside. Off, the spans do nothing.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from deeparc_tpu_torch.config import PipelineOptions
from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.io import DeepArcData
from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
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
    # (L, 3) int64 pose-graph edges (i, j, batch captured), capture order
    edges: np.ndarray | None = None


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


def _covisibility(vis) -> torch.Tensor:
    """(C, C) int64 shared-point counts of a 0/1 (N, C) visibility matrix,
    its diagonal zeroed, on the matrix's device: one float64 product,
    exact for counts below 2**53."""
    vis = torch.as_tensor(vis).to(torch.float64)
    covis = (vis.T @ vis).to(torch.int64)
    covis.fill_diagonal_(0)
    return covis


def bfs_cell_order(mask, n_cells: int, start: int = 0) -> np.ndarray:
    """BFS over the cell covisibility graph (cells sharing >= 1 point) of
    the (N, T) visibility grid ``mask`` (an array or a tensor)."""
    return bfs_cell_order_from_covis(
        _covisibility(torch.as_tensor(mask) > 0.5).cpu().numpy(), start,
        n_cells)


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


def _result(scene, n_batches, order, history, totals,
            edges=None) -> IncrementalResult:
    from deeparc_tpu_torch.pipeline.driver import rmse_px

    with span("deeparc.incremental.final_cost"):
        final_rmse = rmse_px(scene)
    return IncrementalResult(
        scene=scene, batches=n_batches, order=order,
        final_cost=history[-1]["cost"] if history else 0.0,
        final_rmse_px=final_rmse, history=history,
        solve_seconds=totals["seconds"],
        solve_iterations=totals["iterations"], cg_iterations=totals["cg"],
        edges=(np.zeros((0, 3), np.int64) if edges is None else edges))


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


def camera_covisibility(scene) -> torch.Tensor:
    """(C, C) int64 counts of shared points between cameras on the scene's
    device (non-shared scenes: camera == outer extrinsic record), the
    diagonal zero: one float64 product of the dense (N, C) visibility."""
    idx = scene.index
    alive = idx.obs_mask > 0.5
    vis = torch.zeros((scene.n_points, scene.n_extrinsics),
                      dtype=torch.float64, device=idx.obs_point.device)
    vis[idx.obs_point.long()[alive], idx.obs_outer.long()[alive]] = 1.0
    return _covisibility(vis)


def _new_pairs(strong, registered, before) -> torch.Tensor:
    """(n, 2) camera pairs (i, j), i < j, in row-major order, that share
    enough points (``strong``, (C, C) upper triangle) and are registered
    now (``registered``, (C,) bool) but were not both before."""
    both = lambda a: a[:, None] & a[None, :]
    return (strong & both(registered) & ~both(before)).nonzero()


def run_incremental_free(data: DeepArcData,
                         options: PipelineOptions = PipelineOptions(),
                         batch_size: int | None = None, dtype=torch.float64,
                         device="cuda", verbose: bool = True,
                         pose_graph: bool = True,
                         min_covis: int = 3) -> IncrementalResult:
    """Incremental BA for free-camera (non-shared) scenes on the tile
    engine, with pose-graph refinement between batches.

    Cameras are registered ``batch_size`` at a time (default C // 8) in
    BFS order over camera covisibility from camera 0. When a pair of
    registered cameras first shares at least ``min_covis`` points, the
    relative pose of their CURRENT estimates is kept as that edge's
    measurement. Each batch then runs a structure-only solve over the
    points with two active observations, a pose-graph LM of at most 20
    steps over the registered poses (camera record 0 and the unregistered
    cameras anchored, the gauge of ``src/sfm.cc:50-53``), then the full BA
    over the registered cameras.

    One tile layout (``tiles_from_scene`` of the whole scene) and one LM
    step serve every solve: a batch only turns its active observations
    into the buckets' mask planes and its free masks into row space, on
    the scene's device. The edges and their measurements stay there too,
    appended a batch at a time; ``IncrementalResult.edges`` returns them
    as (i, j, batch) rows in capture order."""
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.pipeline.driver import tile_impl
    from deeparc_tpu_torch.residuals.pose_graph import (
        PoseGraph,
        pose_graph_lm,
        relative_pose,
    )
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.solver.tiles import (
        solve_tiles_prepared,
        tiles_from_scene,
        unpermute_points,
    )

    log = print if verbose else (lambda *a, **k: None)
    device = check_device(device)
    with span("deeparc.incremental.load", obs=data.n_obs):
        scene = from_deeparc(data, dtype=dtype, device=device)
    if scene.meta.share_extrinsic:
        raise ValueError("run_incremental_free is the non-shared path")
    C = scene.n_extrinsics
    free0 = freeze_masks(scene)
    with span("deeparc.incremental.layout"):
        tiles, params, free_rows = tiles_from_scene(scene, free0)
    with span("deeparc.incremental.order"):
        covis = camera_covisibility(scene)
        order = bfs_cell_order_from_covis(covis.cpu().numpy())
    if batch_size is None:
        batch_size = max(C // 8, 1)

    impl = tile_impl(options.impl)
    # each slot's camera: its cell's outer extrinsic record
    slot_cam = [tiles.cells.slot_outer.long()[b.cell.long()]
                for b in tiles.buckets]
    n_tail = params.points.shape[0] - sum(b.mask.shape[0]
                                          for b in tiles.buckets)
    cam_frozen = flatten_camera(freeze_masks(scene, freeze_camera=True))
    strong = torch.triu(covis >= min_covis, diagonal=1)
    order_t = torch.as_tensor(order, device=device)
    active = torch.zeros(C + 1, dtype=torch.bool, device=device)
    edges = torch.zeros((0, 3), dtype=torch.long, device=device)
    meas_rot = torch.zeros((0, 3), dtype=dtype, device=device)
    meas_trans = torch.zeros((0, 3), dtype=dtype, device=device)
    pg_options = SolverOptions(max_iterations=20)
    history = []
    totals = {"seconds": 0.0, "iterations": 0, "cg": 0}
    cache: dict = {}    # the step, shared by every solve

    def solve(params, tiles_b, free_points, cam_free):
        res = solve_tiles_prepared(params, tiles_b, free_points, cam_free,
                                   options.solver, impl=impl,
                                   unpermute=False, _cache=cache)
        _add(totals, res)
        return res

    n_batches = -(-C // batch_size)
    for b in range(n_batches):
        n_active = min((b + 1) * batch_size, C)
        with span("deeparc.incremental.batch", batch=b,
                  active_cameras=n_active) as sp:
            before = active[:C].clone()
            active[order_t[b * batch_size:(b + 1) * batch_size]] = True
            if pose_graph:
                # measurements of the pairs that just became registered
                with span("deeparc.incremental.edges"):
                    e = _new_pairs(strong, active[:C], before)
                    mr, mt = relative_pose(
                        params.ext_rot[e[:, 0]], params.ext_trans[e[:, 0]],
                        params.ext_rot[e[:, 1]], params.ext_trans[e[:, 1]])
                    edges = torch.cat([edges, torch.cat(
                        [e, torch.full_like(e[:, :1], b)], dim=1)])
                    meas_rot = torch.cat([meas_rot, mr])
                    meas_trans = torch.cat([meas_trans, mt])

            with span("deeparc.incremental.mask"):
                rows = active.to(dtype)
                masks = [bk.mask * rows[sc]
                         for bk, sc in zip(tiles.buckets, slot_cam)]
                tiles_b = tiles._replace(buckets=tuple(
                    bk._replace(mask=m) for bk, m in zip(tiles.buckets,
                                                         masks)))
                counts = torch.cat([m.sum(dim=1) for m in masks]
                                   + [rows.new_zeros(n_tail)])
                live = (counts >= 2).to(dtype)
                n_live = int(live.sum())
                free_points = free_rows * live[:, None]
                cam_full = flatten_camera(dataclasses.replace(
                    free0, ext_rot=free0.ext_rot * rows[:, None],
                    ext_trans=free0.ext_trans * rows[:, None]))
            sp.set(live_points=n_live, edges=int(edges.shape[0]))

            # structure-only pre-solve on the newly visible points
            # (sfm.cc:111)
            with span("deeparc.incremental.structure"):
                res = solve(params, tiles_b, free_points, cam_frozen)
            params, structure_iterations = res.params, res.iterations

            # pose-graph refinement over the registered cameras
            if pose_graph and edges.shape[0]:
                graph = PoseGraph(edges=edges[:, :2], meas_rot=meas_rot,
                                  meas_trans=meas_trans)
                poses0 = torch.cat([params.ext_rot[:C],
                                    params.ext_trans[:C]], dim=1)
                anchor = ~active[:C]
                anchor[0] = True
                with span("deeparc.incremental.pose_graph", device=True,
                          edges=int(edges.shape[0])) as pg:
                    out = pose_graph_lm(poses0, graph, anchor, pg_options)
                    pg.set(iterations=out.iterations)
                params = dataclasses.replace(
                    params,
                    ext_rot=torch.cat([out.x[:, :3], params.ext_rot[C:]]),
                    ext_trans=torch.cat([out.x[:, 3:],
                                         params.ext_trans[C:]]))

            # full BA over everything registered so far (the rest frozen)
            with span("deeparc.incremental.full"):
                res = solve(params, tiles_b, free_points, cam_full)
            params = res.params
        history.append({"batch": b, "active_cells": n_active,
                        "cost": float(res.cost),
                        "iterations": res.iterations,
                        "structure_iterations": structure_iterations,
                        "live_points": n_live,
                        "edges": int(edges.shape[0])})
        log(f"[incremental-free] batch {b + 1}/{n_batches}: "
            f"{n_active}/{C} cameras, cost={res.cost:.6e}, "
            f"iters={res.iterations}, edges={int(edges.shape[0])}")

    params = dataclasses.replace(
        params, points=unpermute_points(params.points, tiles))
    scene = dataclasses.replace(scene, params=params)
    return _result(scene, n_batches, order, history, totals,
                   edges.cpu().numpy())

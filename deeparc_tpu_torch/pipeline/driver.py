"""The SfM pipeline: hemisphere fit -> freeze solve -> filter loop, PyTorch
port of the single-device branches of
``deeparc_tpu.pipeline.driver.run_pipeline`` (reference ``src/sfm.cc:77-131``):

  1. load the scene, compute camera centers              (sfm.cc:83-86)
  2. fit the hemisphere prior by LM                      (sfm.cc:89-103)
  3. PLY snapshot of the initial scene                   (sfm.cc:110)
  4. points-only BA (freeze_camera=true)                 (sfm.cc:111)
  5. filter outliers                                     (sfm.cc:112)
  6. repeat { full BA; filter; snapshot } until the point
     count stops changing                                (sfm.cc:118-127)
  7. final PLY + refined .deeparc                        (sfm.cc:129-130)

A shared-extrinsic rig runs on the grid engine (``solve_ba_grid``: the
banded kernels when ``band_grid`` finds locality, the monolithic ones
otherwise); a non-shared (BAL-style) scene runs on the tile engine
(``solve_tiles_prepared`` on one layout that every round reuses, the
filter editing its mask planes), each through ``options.impl`` as the
reference routes it (:func:`grid_impl`, :func:`tile_impl`);
``engine="indexed"`` runs the
observation-list engine (``solve_ba``, the scene compacted between
rounds). ``engine="grid-sharded"`` / ``"tiles-sharded"`` run the same
loop with every solve sharded over the ranks of the process group
(``parallel/``; a one-rank group is started when there is none): each
rank runs the whole loop, the hemisphere fit, the layouts and the filter
on the full scene, and only rank 0 logs and writes files. The tensors'
device picks the hand kernels (CUDA) or their plain versions (CPU); the
layouts and their reuse across rounds are the same on both.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from deeparc_tpu_torch.config import PipelineOptions
from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.geometry.camera import (
    camera_center_single,
    hemisphere_camera_centers,
)
from deeparc_tpu_torch.io import DeepArcData, write_deeparc, write_ply
from deeparc_tpu_torch.residuals.reprojection import cost, residuals
from deeparc_tpu_torch.scene import (
    Scene,
    compact,
    freeze_masks,
    from_deeparc,
    to_deeparc,
)
from deeparc_tpu_torch.solver.lm import fit_hemisphere
from deeparc_tpu_torch.utils.profiling import span, traced

ENGINES = ("auto", "grid", "tiles", "indexed", "grid-sharded",
           "tiles-sharded")


class PipelineResult(NamedTuple):
    scene: Scene
    hemisphere: np.ndarray       # [cx, cy, cz, r^2]
    filter_rounds: int
    final_cost: float
    final_rmse_px: float
    rounds: tuple = ()           # per-round records (the sidecar payload)
    solve_iterations: int = 0    # LM iterations over every solve
    solve_seconds: float = 0.0   # wall clock of those LM loops
    cg_iterations: int = 0       # PCG iterations over every solve (tiles)


def scene_camera_centers(scene: Scene) -> torch.Tensor:
    """Hemisphere enumeration in shared mode (``getCameraCenter``,
    DeepArcManager.cc:501-518), else one center per extrinsic."""
    rot, trans = scene.params.ext_rot[:-1], scene.params.ext_trans[:-1]
    if scene.meta.share_extrinsic:
        return hemisphere_camera_centers(rot, trans, scene.meta.arc_size,
                                         scene.meta.ring_size)
    return camera_center_single(rot, trans)


def _camera_composed_flags(scene: Scene) -> np.ndarray:
    """PLY camera coloring: composed iff arc != 0 and ring != 0."""
    if not scene.meta.share_extrinsic:
        return np.zeros(scene.n_extrinsics, dtype=bool)
    A, R = scene.meta.arc_size, scene.meta.ring_size
    return (np.repeat(np.arange(A), R) != 0) & (np.tile(np.arange(R), A) != 0)


def _snapshot(scene: Scene, path: str) -> None:
    with span("deeparc.pipeline.write"):
        data = to_deeparc(scene)
        centers = scene_camera_centers(scene).cpu().numpy().astype(
            np.float64)
        write_ply(path, data.points, data.colors, centers,
                  _camera_composed_flags(scene))


def _sync_grid_masks(scene: Scene, grid) -> Scene:
    """Reflect grid-space masks back onto the observation-list scene (for
    snapshots, export and freeze masks); the gather runs on the device."""
    with span("deeparc.pipeline.sync"):
        cell = torch.as_tensor(
            scene.meta.obs_arc.astype(np.int64) * scene.meta.ring_size
            + scene.meta.obs_ring.astype(np.int64),
            device=scene.params.points.device)
        dtype = scene.params.points.dtype
        index = dataclasses.replace(
            scene.index,
            obs_mask=grid.mask[scene.index.obs_point.long(), cell].to(dtype),
            point_mask=grid.point_mask.to(dtype))
        return dataclasses.replace(scene, index=index)


def _write_sidecar(path, step, result, stats, t_start):
    """The per-round record; persisted when a path is given."""
    sidecar = {
        "round": step, "cost": float(result.cost),
        "iterations": result.iterations, "status": result.status,
        "obs_alive": int(stats.obs_alive),
        "points_alive": int(stats.points_alive),
        "elapsed_s": time.time() - t_start,
    }
    if path:
        with open(path, "w") as f:
            json.dump(sidecar, f, indent=2)
    return sidecar


def rmse_px(scene: Scene) -> float:
    r = residuals(scene.params, scene.index)
    n = max(float(torch.sum(scene.index.obs_mask)), 1.0)
    return float(np.sqrt(float(torch.sum(r * r)) / n))


def grid_impl(impl: str) -> str:
    """The grid engine's impl for ``options.impl``: the tile engine's
    name "xla" means the grid's torch path "planes" (as in the
    reference); "auto" keeps the kernels."""
    return "planes" if impl == "xla" else impl


def tile_impl(impl: str) -> str:
    """The tile engine's impl for ``options.impl``: the grid engine's
    names "planes" / "einsum" mean its torch path "xla" (as in the
    reference); "auto" keeps the kernels."""
    return "xla" if impl in ("planes", "einsum") else impl


def _route(impl: str, dev: torch.device) -> str:
    from deeparc_tpu_torch.solver.rig_grid import KERNEL_IMPLS

    if impl not in KERNEL_IMPLS:
        return "torch ops"
    return "kernels=" + ("cuda" if dev.type == "cuda" else "plain torch")


def _grid_rounds(scene, options, hemi, log, snapshot, sidecar, totals,
                 sharded=False):
    """The freeze solve and the solve/filter rounds on the grid engine
    (``sharded``: each solve over the process group); returns (scene,
    rounds)."""
    from deeparc_tpu_torch.pipeline.filtering import (
        FilterStats,
        filter_masks_grid,
    )
    from deeparc_tpu_torch.parallel.sharded_grid import solve_ba_grid_sharded
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        solve_ba_grid,
    )

    dev, dtype = scene.params.points.device, scene.params.points.dtype
    impl = grid_impl(options.impl)
    with span("deeparc.pipeline.layout"):
        grid = grid_from_scene(scene)
        log(f"[deeparc] engine={'grid-sharded' if sharded else 'grid'} "
            f"({grid.mask.shape[1]} cells, "
            f"{float(grid.mask.mean()) * 100:.1f}% grid density, "
            f"impl={impl}, {_route(impl, dev)})")
    hemi_center = torch.as_tensor(hemi[:3], dtype=dtype, device=dev)
    band_state: dict = {}    # band prep shared across filter rounds

    def run_solve(free, rnd):
        with span("deeparc.pipeline.solve", round=rnd):
            if sharded:
                res = solve_ba_grid_sharded(scene.params, grid, free,
                                            options.solver, impl=impl)
            else:
                res = solve_ba_grid(scene.params, grid, free, options.solver,
                                    band_reuse=band_state, impl=impl)
        totals["iterations"] += res.iterations
        totals["seconds"] += res.seconds
        return res

    def run_filter():
        with span("deeparc.pipeline.filter") as sp:
            mask, pmask = filter_masks_grid(scene.params, grid, hemi_center,
                                            float(hemi[3]), options.filter)
            stats = FilterStats(obs_alive=int(mask.sum()),
                                points_alive=int(pmask.sum()))
            sp.set(obs_alive=stats.obs_alive,
                   points_alive=stats.points_alive)
        return dataclasses.replace(grid, mask=mask, point_mask=pmask), stats

    def point_free_of(free):
        return dataclasses.replace(
            free, points=free.points * grid.point_mask[:, None])

    result = run_solve(point_free_of(freeze_masks(scene, freeze_camera=True)),
                       0)
    scene = dataclasses.replace(scene, params=result.params)
    log(f"[deeparc] freeze-camera solve: cost={result.cost:.6e} "
        f"iters={result.iterations}")
    grid, stats = run_filter()
    log(f"block: {stats.obs_alive}")
    log(f"point3d: {stats.points_alive}")
    scene = _sync_grid_masks(scene, grid)

    step = 0
    rounds: list = []
    snapshot(scene, step)
    old_points, current_points = -1, stats.points_alive
    while current_points != old_points and step < options.max_filter_rounds:
        step += 1
        old_points = current_points
        result = run_solve(point_free_of(freeze_masks(scene)), step)
        scene = dataclasses.replace(scene, params=result.params)
        grid, stats = run_filter()
        scene = _sync_grid_masks(scene, grid)
        current_points = stats.points_alive
        log(f"block: {stats.obs_alive}")
        log(f"point3d: {current_points}")
        snapshot(scene, step)
        rounds.append(sidecar(step, result, stats))
    return scene, rounds


def _tile_rounds(scene, options, hemi, log, snapshot, sidecar, totals,
                 sharded=False):
    """The freeze solve and the solve/filter rounds on the tile engine, on
    one layout that every round reuses (``sharded``: each solve over the
    process group); returns (scene, rounds)."""
    from deeparc_tpu_torch.pipeline.filtering import (
        FilterStats,
        filter_masks_tiles,
    )
    from deeparc_tpu_torch.parallel.sharded_tiles import (
        solve_ba_tiles_sharded,
    )
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.solver.tiles import (
        solve_tiles_prepared,
        tiles_from_scene,
        unpermute_points,
    )

    dev, dtype = scene.params.points.device, scene.params.points.dtype
    impl = tile_impl(options.impl)
    free0 = freeze_masks(scene)
    with span("deeparc.pipeline.layout"):
        tiles, params_t, free_t, slot_src = tiles_from_scene(
            scene, free0, with_slot_src=True)
    v_loc = [b.loc[1].shape[1] if b.loc else None for b in tiles.buckets]
    log(f"[deeparc] engine={'tiles-sharded' if sharded else 'tiles'} "
        f"({tiles.cells.cols.shape[0]} cells, "
        f"{len(tiles.buckets)} width buckets "
        f"{[b.cell.shape[1] for b in tiles.buckets]}, v_local={v_loc}, "
        f"impl={impl}, {_route(impl, dev)})")
    cam_free_full = flatten_camera(free0)
    cam_free_frozen = flatten_camera(freeze_masks(scene, freeze_camera=True))
    sweep_dtype = torch.bfloat16 if options.sweep_dtype == "bf16" else None
    hemi_center = torch.as_tensor(hemi[:3], dtype=dtype, device=dev)
    solve_cache: dict = {}   # the step, shared across filter rounds

    def run_solve(tiles_cur, params_cur, cam_free, free_rows, rnd):
        with span("deeparc.pipeline.solve", round=rnd):
            if sharded:
                res = solve_ba_tiles_sharded(
                    params_cur, tiles_cur, free_rows, cam_free,
                    options.solver, sweep_dtype=sweep_dtype, impl=impl)
            else:
                res = solve_tiles_prepared(
                    params_cur, tiles_cur, free_rows, cam_free,
                    options.solver, impl=impl, unpermute=False,
                    sweep_dtype=sweep_dtype, _cache=solve_cache)
        totals["iterations"] += res.iterations
        totals["seconds"] += res.seconds
        totals["cg"] += res.cg_iterations
        return res

    def run_filter(tiles_cur, params_cur):
        with span("deeparc.pipeline.filter") as sp:
            masks, row_mask = filter_masks_tiles(
                params_cur.points, params_cur, tiles_cur, hemi_center,
                float(hemi[3]), options.filter)
            stats = FilterStats(obs_alive=int(sum(m.sum() for m in masks)),
                                points_alive=int(row_mask.sum()))
            sp.set(obs_alive=stats.obs_alive,
                   points_alive=stats.points_alive)
        buckets = tuple(b._replace(mask=m)
                        for b, m in zip(tiles_cur.buckets, masks))
        return tiles_cur._replace(buckets=buckets), row_mask, stats

    def sync_scene(scn, params_cur, tiles_cur, row_mask):
        """Row-space results back onto the observation-list scene."""
        with span("deeparc.pipeline.sync"):
            pts = unpermute_points(params_cur.points, tiles)
            obs_mask = np.zeros(scn.n_obs)
            for b, src in zip(tiles_cur.buckets, slot_src):
                valid = src >= 0
                obs_mask[src[valid]] = b.mask.cpu().numpy()[valid]
            pmask = row_mask[tiles.row_of_point.long()]
            index = dataclasses.replace(
                scn.index, obs_mask=torch.as_tensor(obs_mask, dtype=dtype,
                                                    device=dev),
                point_mask=pmask.to(dtype))
            return dataclasses.replace(
                scn, params=dataclasses.replace(params_cur, points=pts),
                index=index)

    result = run_solve(tiles, params_t, cam_free_frozen, free_t, 0)
    params_rows = result.params
    log(f"[deeparc] freeze-camera solve: cost={result.cost:.6e} "
        f"iters={result.iterations}")
    tiles_cur, row_mask, stats = run_filter(tiles, params_rows)
    free_rows = free_t * row_mask[:, None]
    log(f"block: {stats.obs_alive}")
    log(f"point3d: {stats.points_alive}")
    scene = sync_scene(scene, params_rows, tiles_cur, row_mask)

    step = 0
    rounds: list = []
    snapshot(scene, step)
    old_points, current_points = -1, stats.points_alive
    while current_points != old_points and step < options.max_filter_rounds:
        step += 1
        old_points = current_points
        result = run_solve(tiles_cur, params_rows, cam_free_full, free_rows,
                           step)
        params_rows = result.params
        tiles_cur, row_mask, stats = run_filter(tiles_cur, params_rows)
        free_rows = free_t * row_mask[:, None]
        scene = sync_scene(scene, params_rows, tiles_cur, row_mask)
        current_points = stats.points_alive
        log(f"block: {stats.obs_alive}")
        log(f"point3d: {current_points}")
        snapshot(scene, step)
        rounds.append(sidecar(step, result, stats))
    return scene, rounds


def _indexed_rounds(scene, options, hemi, log, snapshot, sidecar, totals):
    """The freeze solve and the solve/filter rounds on the observation list
    (``solve_ba``), the scene compacted before each round's solve into
    buckets of 1024 observations and 256 points; returns (scene, rounds)."""
    from deeparc_tpu_torch.pipeline.filtering import filter_outliers
    from deeparc_tpu_torch.solver.ba import solve_ba

    dev = scene.params.points.device
    log(f"[deeparc] engine=indexed ({scene.n_obs} observations, "
        f"kernels={'cuda' if dev.type == 'cuda' else 'plain torch'})")

    def run_solve(free, rnd):
        with span("deeparc.pipeline.solve", round=rnd):
            res = solve_ba(scene.params, scene.index, free, options.solver)
        totals["iterations"] += res.iterations
        totals["seconds"] += res.seconds
        return res

    def run_filter(scn):
        with span("deeparc.pipeline.filter") as sp:
            scn, stats = filter_outliers(scn, hemi[:3], hemi[3],
                                         options.filter)
            sp.set(obs_alive=stats.obs_alive,
                   points_alive=stats.points_alive)
        return scn, stats

    # points-only pre-solve (freeze_camera=true; sfm.cc:111)
    result = run_solve(freeze_masks(scene, freeze_camera=True), 0)
    scene = dataclasses.replace(scene, params=result.params)
    log(f"[deeparc] freeze-camera solve: cost={result.cost:.6e} "
        f"iters={result.iterations}")
    scene, stats = run_filter(scene)
    log(f"block: {stats.obs_alive}")
    log(f"point3d: {stats.points_alive}")

    step = 0
    rounds: list = []
    snapshot(scene, step)
    old_points, current_points = -1, stats.points_alive
    while current_points != old_points and step < options.max_filter_rounds:
        step += 1
        old_points = current_points
        with span("deeparc.pipeline.compact"):
            scene = compact(scene, obs_bucket=1024, point_bucket=256)
        result = run_solve(freeze_masks(scene), step)
        scene = dataclasses.replace(scene, params=result.params)
        scene, stats = run_filter(scene)
        current_points = stats.points_alive
        log(f"block: {stats.obs_alive}")
        log(f"point3d: {current_points}")
        snapshot(scene, step)
        rounds.append(sidecar(step, result, stats))
    return scene, rounds


@traced("deeparc.pipeline")
def run_pipeline(data: DeepArcData,
                 options: PipelineOptions = PipelineOptions(),
                 output_dir: Optional[str] = None, basename: str = "scene",
                 dtype=torch.float64, device="cuda",
                 verbose: bool = True) -> PipelineResult:
    """The whole pipeline on ``device``. ``engine="auto"`` takes the grid
    engine for a shared-extrinsic rig and the tile engine otherwise;
    ``"grid"``, ``"tiles"`` and ``"indexed"`` force one;
    ``"grid-sharded"`` and ``"tiles-sharded"`` shard every solve over the
    process group's ranks (``options.devices``, when set, must be its
    size); ``data`` is read by field name (the reference's ``DeepArcData``
    serves as well as the port's)."""
    device = check_device(device)
    engine = options.engine
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    sharded = engine.endswith("-sharded")
    rank = 0
    if sharded:
        import torch.distributed as dist

        from deeparc_tpu_torch.parallel.multihost import (
            start_group,
            world_hint,
        )

        start_group(device)
        world, rank = dist.get_world_size(), dist.get_rank()
        if options.devices is not None and options.devices != world:
            raise ValueError(f"devices={options.devices} in a world of "
                             f"{world} ranks: {world_hint(options.devices)}")
    use_grid = engine in ("grid", "grid-sharded") or (
        engine == "auto" and data.share_extrinsic)

    t_start = time.time()
    # every rank runs the loop; rank 0 alone logs and writes files
    output_dir = output_dir if rank == 0 else None
    out = lambda name: os.path.join(output_dir, name) if output_dir else None
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    log = print if verbose and rank == 0 else (lambda *a, **k: None)

    with span("deeparc.pipeline.load"):
        scene = from_deeparc(data, dtype=dtype, device=device)
    log(f"[deeparc] loaded: {scene.n_obs} obs, {scene.n_points} points, "
        f"{scene.n_extrinsics} extrinsics, {scene.n_intrinsics} intrinsics, "
        f"share_extrinsic={scene.meta.share_extrinsic}, device={device}")
    if sharded:
        log(f"[deeparc] process group: world size {world} "
            f"({dist.get_backend()})")

    with span("deeparc.pipeline.hemisphere"):
        hemi = fit_hemisphere(scene_camera_centers(scene),
                              options.hemisphere_max_iterations).cpu().numpy()
    log(f"[deeparc] hemisphere fit: center={hemi[:3]} r^2={hemi[3]:.6f}")
    if output_dir and options.write_snapshots:
        _snapshot(scene, out(f"{basename}_init.ply"))

    def snapshot(scn, step):
        if output_dir and options.write_snapshots:
            _snapshot(scn, out(f"{basename}_adjust_point_{step}.ply"))

    def sidecar(step, result, stats):
        return _write_sidecar(
            out(f"{basename}_state.json") if output_dir else None,
            step, result, stats, t_start)

    totals = {"iterations": 0, "seconds": 0.0, "cg": 0}
    if engine == "indexed":
        scene, rounds_log = _indexed_rounds(scene, options, hemi, log,
                                            snapshot, sidecar, totals)
    else:
        rounds_fn = _grid_rounds if use_grid else _tile_rounds
        scene, rounds_log = rounds_fn(scene, options, hemi, log, snapshot,
                                      sidecar, totals, sharded=sharded)

    log(f"TOTAL REPEAT: {len(rounds_log)}")
    with span("deeparc.pipeline.compact"):
        scene = compact(scene)
    if output_dir:
        _snapshot(scene, out(f"{basename}_clear.ply"))
        with span("deeparc.pipeline.write"):
            write_deeparc(to_deeparc(scene),
                          out(f"{basename}_output.deeparc"))
    with span("deeparc.pipeline.final_cost"):
        final_cost = float(cost(scene.params, scene.index))
        final_rmse = rmse_px(scene)
    return PipelineResult(
        scene=scene, hemisphere=hemi, filter_rounds=len(rounds_log),
        final_cost=final_cost, final_rmse_px=final_rmse,
        rounds=tuple(rounds_log),
        solve_iterations=totals["iterations"],
        solve_seconds=totals["seconds"], cg_iterations=totals["cg"])

"""The SfM pipeline on the grid engine: hemisphere fit -> freeze solve ->
filter loop, PyTorch port of the grid branch of
``deeparc_tpu.pipeline.driver.run_pipeline`` (reference ``src/sfm.cc:77-131``):

  1. load the scene, compute camera centers              (sfm.cc:83-86)
  2. fit the hemisphere prior by LM                      (sfm.cc:89-103)
  3. PLY snapshot of the initial scene                   (sfm.cc:110)
  4. points-only BA (freeze_camera=true)                 (sfm.cc:111)
  5. filter outliers                                     (sfm.cc:112)
  6. repeat { full BA; filter; snapshot } until the point
     count stops changing                                (sfm.cc:118-127)
  7. final PLY + refined .deeparc                        (sfm.cc:129-130)

Every solve is ``solve_ba_grid``: the banded kernels when ``band_grid``
finds locality, the monolithic ones otherwise. The
tensors' device picks the hand kernels (CUDA) or their plain versions
(CPU); the band prep and its reuse across rounds are the same on both.
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

# what the port does not run yet, and the ROADMAP.md item that ports it
_NOT_PORTED = {
    "tiles": "the tile engine (ROADMAP.md Queue 1 item 8)",
    "indexed": "the indexed engine (ROADMAP.md Queue 1 item 9)",
    "grid-sharded": "the sharded engines (ROADMAP.md Queue 1 item 10)",
    "tiles-sharded": "the sharded engines (ROADMAP.md Queue 1 item 10)",
}


class PipelineResult(NamedTuple):
    scene: Scene
    hemisphere: np.ndarray       # [cx, cy, cz, r^2]
    filter_rounds: int
    final_cost: float
    final_rmse_px: float
    rounds: tuple = ()           # per-round records (the sidecar payload)
    solve_iterations: int = 0    # LM iterations over every solve
    solve_seconds: float = 0.0   # wall clock of those LM loops


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
    data = to_deeparc(scene)
    centers = scene_camera_centers(scene).cpu().numpy().astype(np.float64)
    write_ply(path, data.points, data.colors, centers,
              _camera_composed_flags(scene))


def _sync_grid_masks(scene: Scene, grid) -> Scene:
    """Reflect grid-space masks back onto the observation-list scene (for
    snapshots, export and freeze masks); the gather runs on the device."""
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


def check_device(device) -> torch.device:
    """The device to run on; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device (pass device='cpu' to run the plain "
                           "PyTorch versions of the kernels)")
    return device


def run_pipeline(data: DeepArcData,
                 options: PipelineOptions = PipelineOptions(),
                 output_dir: Optional[str] = None, basename: str = "scene",
                 dtype=torch.float64, device="cuda",
                 verbose: bool = True) -> PipelineResult:
    from deeparc_tpu_torch.pipeline.filtering import (
        FilterStats,
        filter_masks_grid,
    )
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        solve_ba_grid,
    )

    device = check_device(device)
    engine = options.engine
    if engine in _NOT_PORTED:
        raise NotImplementedError(f"engine={engine!r}: {_NOT_PORTED[engine]}"
                                  " is not ported yet")
    if not data.share_extrinsic:
        raise NotImplementedError(
            f"a non-shared scene needs {_NOT_PORTED['tiles']}, which is not "
            "ported yet")
    if engine not in ("auto", "grid"):
        raise ValueError(f"unknown engine {engine!r}")
    if options.impl not in ("auto", "pallas"):
        raise NotImplementedError(
            f"impl={options.impl!r}: the port runs the grid engine through "
            "its hand kernels only (the einsum/planes impls are left out, "
            "ROADMAP.md Queue 1)")

    t_start = time.time()
    out = lambda name: os.path.join(output_dir, name) if output_dir else None
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    log = print if verbose else (lambda *a, **k: None)

    scene = from_deeparc(data, dtype=dtype, device=device)
    log(f"[deeparc] loaded: {scene.n_obs} obs, {scene.n_points} points, "
        f"{scene.n_extrinsics} extrinsics, {scene.n_intrinsics} intrinsics, "
        f"share_extrinsic={scene.meta.share_extrinsic}, device={device}")

    hemi = fit_hemisphere(scene_camera_centers(scene),
                          options.hemisphere_max_iterations).cpu().numpy()
    log(f"[deeparc] hemisphere fit: center={hemi[:3]} r^2={hemi[3]:.6f}")
    if output_dir and options.write_snapshots:
        _snapshot(scene, out(f"{basename}_init.ply"))

    grid = grid_from_scene(scene)
    log(f"[deeparc] engine=grid ({grid.mask.shape[1]} cells, "
        f"{float(grid.mask.mean()) * 100:.1f}% grid density, "
        f"kernels={'cuda' if device.type == 'cuda' else 'plain torch'})")
    hemi_center = torch.as_tensor(hemi[:3], dtype=dtype, device=device)
    band_state: dict = {}    # band prep shared across filter rounds
    totals = {"iterations": 0, "seconds": 0.0}

    def run_solve(free):
        res = solve_ba_grid(scene.params, grid, free, options.solver,
                            band_reuse=band_state)
        totals["iterations"] += res.iterations
        totals["seconds"] += res.seconds
        return res

    def run_filter():
        mask, pmask = filter_masks_grid(scene.params, grid, hemi_center,
                                        float(hemi[3]), options.filter)
        stats = FilterStats(obs_alive=int(mask.sum()),
                            points_alive=int(pmask.sum()))
        return dataclasses.replace(grid, mask=mask, point_mask=pmask), stats

    def point_free_of(free):
        return dataclasses.replace(
            free, points=free.points * grid.point_mask[:, None])

    result = run_solve(point_free_of(freeze_masks(scene, freeze_camera=True)))
    scene = dataclasses.replace(scene, params=result.params)
    log(f"[deeparc] freeze-camera solve: cost={result.cost:.6e} "
        f"iters={result.iterations}")
    grid, stats = run_filter()
    log(f"block: {stats.obs_alive}")
    log(f"point3d: {stats.points_alive}")
    scene = _sync_grid_masks(scene, grid)

    step = 0
    rounds_log: list = []
    if output_dir and options.write_snapshots:
        _snapshot(scene, out(f"{basename}_adjust_point_{step}.ply"))
    old_points, current_points = -1, stats.points_alive
    while current_points != old_points and step < options.max_filter_rounds:
        step += 1
        old_points = current_points
        result = run_solve(point_free_of(freeze_masks(scene)))
        scene = dataclasses.replace(scene, params=result.params)
        grid, stats = run_filter()
        scene = _sync_grid_masks(scene, grid)
        current_points = stats.points_alive
        log(f"block: {stats.obs_alive}")
        log(f"point3d: {current_points}")
        if output_dir and options.write_snapshots:
            _snapshot(scene, out(f"{basename}_adjust_point_{step}.ply"))
        rounds_log.append(_write_sidecar(
            out(f"{basename}_state.json") if output_dir else None,
            step, result, stats, t_start))

    log(f"TOTAL REPEAT: {step}")
    scene = compact(scene)
    if output_dir:
        _snapshot(scene, out(f"{basename}_clear.ply"))
        write_deeparc(to_deeparc(scene), out(f"{basename}_output.deeparc"))
    return PipelineResult(
        scene=scene, hemisphere=hemi, filter_rounds=step,
        final_cost=float(cost(scene.params, scene.index)),
        final_rmse_px=rmse_px(scene), rounds=tuple(rounds_log),
        solve_iterations=totals["iterations"],
        solve_seconds=totals["seconds"])

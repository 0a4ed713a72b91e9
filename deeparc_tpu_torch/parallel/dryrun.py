"""One LM step of each sharded engine on tiny shapes in the current process
group, each held against the same step on one device, and one sharded
pipeline round: the port's counterpart of the reference's
``dryrun_multichip``.

    python -m deeparc_tpu_torch.parallel.dryrun 1              # on the card
    torchrun --nproc-per-node 4 -m deeparc_tpu_torch.parallel.dryrun 4
    python -m deeparc_tpu_torch.parallel.dryrun 1 --device cpu
"""

from __future__ import annotations

import argparse
import math
import sys

import torch.distributed as dist


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run one sharded LM step of the grid, indexed and tile engines (and of
    the multi-host grid solve on a (2, n/2) mesh when n is even and >= 4)
    over the group's ``n_devices`` ranks (a one-rank group is started for
    ``n_devices = 1`` when none is), each against the single-device step,
    and one sharded pipeline round. Raises on a mismatch; returns the
    relative cost differences."""
    from deeparc_tpu_torch.config import (
        FilterOptions,
        PipelineOptions,
        SolverOptions,
    )
    from deeparc_tpu_torch.device import check_device
    from deeparc_tpu_torch.io import make_hemisphere_rig
    from deeparc_tpu_torch.parallel.multihost import (
        make_host_mesh,
        solve_ba_grid_multihost,
        start_group,
        world_hint,
    )
    from deeparc_tpu_torch.parallel.sharded_ba import (
        shard_scene,
        solve_ba_sharded,
    )
    from deeparc_tpu_torch.parallel.sharded_grid import solve_ba_grid_sharded
    from deeparc_tpu_torch.parallel.sharded_tiles import (
        solve_ba_tiles_sharded,
    )
    from deeparc_tpu_torch.pipeline import run_pipeline
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.ba import solve_ba
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        solve_ba_grid,
    )
    from deeparc_tpu_torch.solver.tiles import (
        solve_tiles_prepared,
        tiles_from_scene,
    )

    device = check_device(device)
    start_group(device)
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a world of "
                         f"{dist.get_world_size()} ranks: "
                         f"{world_hint(n_devices)}")
    # 1024 points: every rank of a small group holds real rows
    data = make_hemisphere_rig(n_arc=3, n_ring=6, n_points=1024,
                               pixel_noise=0.2, point_noise=0.04,
                               seed=0).data
    scene = from_deeparc(data, device=device)
    free = freeze_masks(scene)
    grid = grid_from_scene(scene)
    options = SolverOptions(max_iterations=1)
    rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    errs = {}

    ref_g = solve_ba_grid(scene.params, grid, free, options,
                          band_reuse={"prep": None})
    out_g = solve_ba_grid_sharded(scene.params, grid, free, options)
    errs["grid"] = rel(out_g.cost, ref_g.cost)

    out_i = solve_ba_sharded(shard_scene(scene, free, n_devices), options,
                             device=device)
    errs["indexed"] = rel(out_i.cost,
                          solve_ba(scene.params, scene.index, free,
                                   options).cost)

    tiles, params_t, free_t = tiles_from_scene(scene, free, chunk_obs=256)
    cam_free = flatten_camera(free)
    tile_opts = SolverOptions(max_iterations=1,
                              linear_solver="iterative_schur",
                              cg_max_iterations=30)
    out_t = solve_ba_tiles_sharded(params_t, tiles, free_t, cam_free,
                                   tile_opts, chunk_obs=256)
    errs["tiles"] = rel(out_t.cost, solve_tiles_prepared(
        params_t, tiles, free_t, cam_free, tile_opts).cost)

    if n_devices % 2 == 0 and n_devices >= 4:
        out_2d = solve_ba_grid_multihost(
            scene.params, grid, free, options,
            mesh=make_host_mesh(n_devices // 2))
        errs["2d-mesh"] = rel(out_2d.cost, ref_g.cost)

    for name, out in (("grid", out_g), ("tiles", out_t)):
        if out.iterations != 1 or not math.isfinite(out.cost):
            raise AssertionError(f"{name}: {out.iterations} iterations, "
                                 f"cost {out.cost}")
    if out_i.iterations != 1:
        raise AssertionError(f"indexed: {out_i.iterations} iterations")

    # one sharded pipeline round (solve -> filter -> solve)
    pipe = run_pipeline(data, PipelineOptions(
        solver=SolverOptions(max_iterations=2),
        filter=FilterOptions(error_boundary=25.0), max_filter_rounds=1,
        write_snapshots=False, engine="grid-sharded", devices=n_devices),
        device=device, verbose=False)
    if not (pipe.filter_rounds >= 1 and pipe.final_rmse_px < 1.0):
        raise AssertionError(f"sharded pipeline: {pipe.filter_rounds} "
                             f"rounds, RMSE {pipe.final_rmse_px}")
    # one step from one start: sums in another order, float64
    worst = max(errs.values())
    if not worst < 1e-9:
        raise AssertionError(f"sharded / single-device cost mismatch {errs}")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n_devices}): ok, one sharded LM step on "
              f"every engine against one device, relative cost differences "
              f"{ {k: f'{v:.2e}' for k, v in errs.items()} }; one sharded "
              f"pipeline round, RMSE {pipe.final_rmse_px:.4f} px")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())

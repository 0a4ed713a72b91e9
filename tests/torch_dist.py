"""Process groups for the port's sharded tests: rank functions that run in
spawned processes of a gloo group on the CPU. This module imports only
``torch``, numpy and the port, so the spawned ranks never import JAX.

``spawn(fn, n, tmp_path, *args)`` starts ``n`` ranks without waiting; each
joins the group through a ``file://`` rendezvous in ``tmp_path`` (never a
fixed port: several test workers run at once), runs ``fn(rank, n, *args)``
and rank 0 pickles the returned dict; ``Group.result()`` waits for the
ranks and returns it. ``spawn_torchrun`` starts the ranks as ``torchrun``
would (its environment, a free local port, ``LOCAL_WORLD_SIZE`` ranks a
host), and they join through the port's own ``start_group``."""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import socket

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from deeparc_tpu_torch.config import (
    FilterOptions,
    PipelineOptions,
    SolverOptions,
)

TIMEOUT_S = 240


class Group:
    def __init__(self, ctx, out):
        self.ctx, self.out = ctx, out

    def result(self) -> dict:
        while not self.ctx.join(timeout=TIMEOUT_S):
            pass
        with open(self.out, "rb") as f:
            return pickle.load(f)


def _rank_main(rank, fn, n, rdv, out, args, env=None):
    torch.set_num_threads(1)
    if env is None:
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                world_size=n, rank=rank)
    else:
        from deeparc_tpu_torch.parallel.multihost import start_group

        local = int(env["LOCAL_WORLD_SIZE"])
        os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(rank % local))
        start_group("cpu")
    try:
        res = fn(rank, n, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, n, tmp_path, *args) -> Group:
    tag = f"{fn.__name__}_{n}"
    out = os.path.join(str(tmp_path), f"{tag}.pkl")
    rdv = os.path.join(str(tmp_path), f"{tag}.rdv")
    ctx = mp.start_processes(_rank_main, args=(fn, n, rdv, out, args),
                             nprocs=n, join=False, start_method="spawn")
    return Group(ctx, out)


def spawn_torchrun(fn, n, per_host, tmp_path, *args) -> Group:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(str(tmp_path), f"{fn.__name__}_{n}.pkl")
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(per_host))
    ctx = mp.start_processes(_rank_main,
                             args=(fn, n, None, out, args, env), nprocs=n,
                             join=False, start_method="spawn")
    return Group(ctx, out)


def np_of(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def result_of(res) -> dict:
    """A BAResult as numpy: points, camera vector, cost, iterations."""
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera

    return dict(points=np_of(res.params.points),
                cam_vec=np_of(flatten_camera(res.params)),
                cost=float(res.cost), iterations=int(res.iterations))


# ---------------------------------------------------------------------------
# The problems (the reference's test problems, as numpy data)
# ---------------------------------------------------------------------------


def rig_data():
    """tests/test_dist.py's rig."""
    from deeparc_tpu_torch.io import make_hemisphere_rig

    return make_hemisphere_rig(n_arc=3, n_ring=6, n_points=120,
                               pixel_noise=0.4, point_noise=0.04,
                               seed=21).data


# a scene of three width buckets, each locality-blocked, at TILE_CHUNK
TILE_CHUNK = 64


def bal_data():
    from deeparc_tpu_torch.io import make_bal_synthetic

    return make_bal_synthetic(n_cameras=10, n_points=150, track_length=5.0,
                              pixel_noise=0.5, point_noise=0.05,
                              seed=7).data


GRID_OPTS = SolverOptions(max_iterations=10)
INDEXED_OPTS = SolverOptions(max_iterations=12)
TILE_OPTS = SolverOptions(linear_solver="iterative_schur",
                          cg_max_iterations=40, max_iterations=6)


def _scene(data):
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc

    scene = from_deeparc(data, device="cpu")
    return scene, freeze_masks(scene)


def _tile_layout(data):
    from deeparc_tpu_torch.solver.tiles import tiles_from_scene

    scene, free = _scene(data)
    tiles, params_t, free_t = tiles_from_scene(scene, free,
                                               chunk_obs=TILE_CHUNK)
    return scene, free, tiles, params_t, free_t


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------


def sharded_solves(rank, n):
    """The three sharded solves under both drivers (``<name>_while_loop``:
    ``driver="while_loop"``, grid and tiles in blocks of 3), and on rank 0
    the single-device grid solve on the monolithic route."""
    from deeparc_tpu_torch.parallel.sharded_ba import (
        make_mesh,
        shard_scene,
        solve_ba_sharded,
    )
    from deeparc_tpu_torch.parallel.sharded_grid import solve_ba_grid_sharded
    from deeparc_tpu_torch.parallel.sharded_tiles import (
        solve_ba_tiles_sharded,
    )
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        solve_ba_grid,
    )

    out = {}
    scene, free = _scene(rig_data())
    grid = grid_from_scene(scene)
    blocks = dict(driver="while_loop", while_block=3)
    out["grid"] = result_of(solve_ba_grid_sharded(
        scene.params, grid, free, GRID_OPTS))
    out["grid_while_loop"] = result_of(solve_ba_grid_sharded(
        scene.params, grid, free, GRID_OPTS, **blocks))
    if rank == 0:
        out["grid_single"] = result_of(solve_ba_grid(
            scene.params, grid, free, GRID_OPTS, band_reuse={"prep": None}))
    # over a 1-D mesh, as the reference's tests call it
    mesh = make_mesh(n, device="cpu")
    for driver in ("python", "while_loop"):
        res = solve_ba_sharded(shard_scene(scene, free, n), INDEXED_OPTS,
                               mesh=mesh, device="cpu", driver=driver)
        key = "indexed" if driver == "python" else "indexed_while_loop"
        out[key] = dict(points=np_of(res.points), cam_vec=np_of(res.cam_vec),
                        cost=float(res.cost), iterations=res.iterations)
    scene, free, tiles, params_t, free_t = _tile_layout(bal_data())
    out["tiles"] = result_of(solve_ba_tiles_sharded(
        params_t, tiles, free_t, flatten_camera(free), TILE_OPTS,
        chunk_obs=TILE_CHUNK))
    out["tiles_while_loop"] = result_of(solve_ba_tiles_sharded(
        params_t, tiles, free_t, flatten_camera(free), TILE_OPTS,
        chunk_obs=TILE_CHUNK, **blocks))
    return out


def _pipeline_opts(engine, devices):
    if engine == "grid-sharded":
        return PipelineOptions(solver=SolverOptions(max_iterations=20),
                               write_snapshots=False, engine=engine,
                               devices=devices)
    return PipelineOptions(
        solver=SolverOptions(linear_solver="iterative_schur",
                             max_iterations=8, cg_max_iterations=40),
        filter=FilterOptions(error_boundary=5.0, hemisphere_cut=True),
        max_filter_rounds=3, write_snapshots=False, engine=engine,
        devices=devices)


def pipeline_data(engine):
    """An occlusion rig for the grid engine, a windowed BAL scene (one
    locality-blocked bucket) for the tile engine."""
    from deeparc_tpu_torch.io import make_bal_windowed_host, make_hemisphere_rig

    if engine == "grid-sharded":
        return make_hemisphere_rig(n_arc=3, n_ring=16, n_points=420,
                                   occlusion_rings=4, visibility=0.9,
                                   pixel_noise=0.8, point_noise=0.02,
                                   seed=5).data
    return make_bal_windowed_host(n_cameras=40, n_points=600, track_length=6,
                                  window=12, n_hubs=3, seed=6)


def pipelines(rank, n, engines, out_dir):
    """``run_pipeline`` with each sharded engine; rank 0 writes the output
    files."""
    from deeparc_tpu_torch.pipeline import run_pipeline

    out = {}
    for engine in engines:
        res = run_pipeline(pipeline_data(engine), _pipeline_opts(engine, n),
                           output_dir=os.path.join(out_dir, str(rank)),
                           basename=engine, device="cpu", verbose=False)
        out[engine] = dict(rounds=res.filter_rounds,
                           n_points=res.scene.n_points,
                           final_cost=res.final_cost,
                           final_rmse_px=res.final_rmse_px)
    return out


def operational(rank, n, work):
    """The wall-clock cap, checkpoints, resume and log lines of both sharded
    solves under both drivers (``<name>_while_loop``: blocks of 2); each
    rank passes its own checkpoint and log paths, so the files show which
    rank wrote them."""
    from deeparc_tpu_torch.parallel.sharded_grid import solve_ba_grid_sharded
    from deeparc_tpu_torch.parallel.sharded_tiles import (
        solve_ba_tiles_sharded,
    )
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene
    from deeparc_tpu_torch.utils.logging import JsonlLogger

    scene, free = _scene(rig_data())
    grid = grid_from_scene(scene)
    _, tfree, tiles, params_t, free_t = _tile_layout(bal_data())
    cam_free = flatten_camera(tfree)
    tile_opts = lambda **kw: dataclasses.replace(TILE_OPTS, **kw)
    solves = {
        "grid": lambda opts, **kw: solve_ba_grid_sharded(
            scene.params, grid, free, opts, **kw),
        "tiles": lambda opts, **kw: solve_ba_tiles_sharded(
            params_t, tiles, free_t, cam_free, opts, chunk_obs=TILE_CHUNK,
            **kw),
    }
    out = {}
    for name, solve in solves.items():
        opts = GRID_OPTS if name == "grid" else tile_opts()
        ck = os.path.join(work, f"{name}_ck_{rank}.npz")
        log = os.path.join(work, f"{name}_log_{rank}.jsonl")
        rec = {"zero_budget": solve(dataclasses.replace(
            opts, max_iterations=100, max_seconds=0.0)).iterations}
        full = solve(dataclasses.replace(opts, max_iterations=4))
        with JsonlLogger(log) as logger:
            a = solve(dataclasses.replace(opts, max_iterations=2),
                      checkpoint_path=ck, checkpoint_every=2, logger=logger)
        # rank 0 decides that the checkpoint exists and reads it, also for
        # a rank whose own path holds none
        b = solve(dataclasses.replace(opts, max_iterations=4),
                  checkpoint_path=ck, resume=True)
        lines = [json.loads(line) for line in open(log)] \
            if os.path.exists(log) else []
        rec.update(a_iterations=a.iterations, a_cost=a.cost,
                   b_iterations=b.iterations, b_cost=b.cost,
                   full_cost=full.cost, log_events=[r["event"] for r in lines],
                   wrote_checkpoint=os.path.exists(ck))
        out[name] = rec
        out[f"{name}_while_loop"] = _operational_blocks(
            lambda o, **kw: solve(o, driver="while_loop", while_block=2,
                                  **kw),
            opts, work, f"{name}_while_loop", rank)
    return out


def _operational_blocks(solve, opts, work, tag, rank):
    """The while_loop driver's operational record: a zero budget, an
    uninterrupted 5-iteration solve, a 3-iteration solve with a checkpoint
    and a log (blocks end at 2 and 3) and its resume to 5."""
    from deeparc_tpu_torch.utils.logging import JsonlLogger

    # no convergence test ends these solves before their iterations
    opts = dataclasses.replace(opts, function_tolerance=0.0,
                               parameter_tolerance=0.0,
                               gradient_tolerance=0.0)
    ck = os.path.join(work, f"{tag}_ck_{rank}.npz")
    log = os.path.join(work, f"{tag}_log_{rank}.jsonl")
    rec = {"zero_budget": solve(dataclasses.replace(
        opts, max_iterations=100, max_seconds=0.0)).iterations}
    full = solve(dataclasses.replace(opts, max_iterations=5))
    with JsonlLogger(log) as logger:
        a = solve(dataclasses.replace(opts, max_iterations=3),
                  checkpoint_path=ck, logger=logger)
    b = solve(dataclasses.replace(opts, max_iterations=5),
              checkpoint_path=ck, resume=True)
    lines = [json.loads(line) for line in open(log)] \
        if os.path.exists(log) else []
    rec.update(a_iterations=a.iterations, b_iterations=b.iterations,
               full=result_of(full), b=result_of(b), log=lines,
               wrote_checkpoint=os.path.exists(ck))
    return rec


def several(rank, n, calls):
    """Several rank functions in one group, ``calls`` = ((name, args),
    ...): {name: the function's result}."""
    return {name: globals()[name](rank, n, *args) for name, args in calls}


def multihost(rank, n):
    """The multi-host helpers and grid solve on the (hosts, chips) mesh of
    torchrun's environment."""
    from deeparc_tpu_torch.parallel.multihost import (
        gather_global,
        global_from_host_local,
        host_point_slice,
        make_host_mesh,
        pad_rows_to_mesh,
        solve_ba_grid_multihost,
    )
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene

    from deeparc_tpu_torch.io import make_hemisphere_rig
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc

    # tests/test_multihost.py's problem
    data = make_hemisphere_rig(n_arc=3, n_ring=4, n_points=64,
                               pixel_noise=0.3, point_noise=0.02,
                               seed=11).data
    scene = from_deeparc(data, device="cpu")
    free = freeze_masks(scene)
    mesh = make_host_mesh()
    rows = pad_rows_to_mesh(scene.n_points + 1, mesh)
    sl = host_point_slice(rows, mesh)
    table = np.arange(rows * 3, dtype=np.float64).reshape(rows, 3)
    local = global_from_host_local(table[sl], mesh, rows)
    res = solve_ba_grid_multihost(scene.params, grid_from_scene(scene), free,
                                  SolverOptions(max_iterations=4), mesh=mesh,
                                  chunk_size=16)
    blocks = solve_ba_grid_multihost(
        scene.params, grid_from_scene(scene), free,
        SolverOptions(max_iterations=4), mesh=mesh, chunk_size=16,
        driver="while_loop", while_block=3)
    return dict(mesh_shape=tuple(mesh.mesh.shape),
                dim_names=tuple(mesh.mesh_dim_names), rows=rows,
                gathered=gather_global(local), table=table,
                result=result_of(res), result_while_loop=result_of(blocks))

"""Sharded bundle adjustment on the observation list (the indexed engine),
PyTorch port of ``deeparc_tpu.parallel.sharded_ba``.

Points are split into contiguous shards, one per rank of the process
group, and every observation lives on its point's shard, so the 3x3 point
eliminations, g_p and the back-substitution are rank-local. The reduced
camera system is small and replicated: each rank computes its shard's
part of g_c, the diagonal of H_cc, S = H_cc - E^T B^-1 E and the reduced
rhs with the port's Schur pieces (``solver/schur.py``, its row sums through
the shard's own ``schur_maps``), and one ``all_reduce`` each assembles
them. The trust-region scalars derive from summed quantities, so every
rank takes the same decisions.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.parallel.multihost import (
    mesh_device_type,
    reducer_for,
    start_group,
    world_hint,
)
from deeparc_tpu_torch.residuals.reprojection import (
    cost as cost_fn,
    flatten_camera,
    jacobian_blocks_flat,
    unflatten_camera,
)
from deeparc_tpu_torch.scene import BAParams, Scene, SceneIndex, _np
from deeparc_tpu_torch.solver import trust_region as tr_mod
from deeparc_tpu_torch.solver.ba import check_driver, run_steps
from deeparc_tpu_torch.solver.device_loop import BlockLoop, run_blocks
from deeparc_tpu_torch.solver.linalg import masked_spd_solve
from deeparc_tpu_torch.solver.schur import (
    _cam_aug_diag,
    augmented_point_blocks,
    back_substitute,
    build_system,
    dense_S,
    j_times,
    reduced_rhs,
    schur_maps,
    sys_r,
)


class ShardedScene(NamedTuple):
    """Host-prepared shard-major arrays (leading dim = number of shards)."""

    # per-shard observation arrays (S, M_s, ...) -- obs_point is SHARD-LOCAL
    obs_point: np.ndarray
    obs_outer: np.ndarray
    obs_inner: np.ndarray
    obs_intr: np.ndarray
    obs_xy: np.ndarray
    obs_mask: np.ndarray
    # per-shard point tables (S, N_s, ...)
    points: np.ndarray
    point_mask: np.ndarray
    point_free: np.ndarray
    # replicated camera tables / masks
    ext_rot: np.ndarray
    ext_trans: np.ndarray
    center: np.ndarray
    focal: np.ndarray
    dist: np.ndarray
    focal_shared: np.ndarray
    dist_m1: np.ndarray
    dist_m2: np.ndarray
    cam_free: np.ndarray     # (C,)


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device="cuda"):
    """A 1-D ``DeviceMesh`` named ``axis`` over the world's ranks (a
    one-rank group on ``device`` is started if none is). A rank is one
    device, so ``n_devices``, when given, must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    start_group(check_device(device))
    world = torch.distributed.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices in a world of "
                         f"{world} ranks: {world_hint(n_devices)}")
    return init_device_mesh(mesh_device_type(), (world,),
                            mesh_dim_names=(axis,))


def shard_scene(scene: Scene, free: BAParams, n_shards: int) -> ShardedScene:
    """Partition points (and their observations) into n contiguous shards.

    Observations are already point-sorted (``scene.from_deeparc``); shards
    are padded to a common observation count / point count with dead
    (masked) entries, so every rank's arrays have one shape."""
    N = scene.n_points
    n_local = -(-N // n_shards)
    obs_point = _np(scene.index.obs_point)
    shard_of_point = np.minimum(np.arange(N) // n_local, n_shards - 1)
    obs_shard = shard_of_point[obs_point]
    counts = np.bincount(obs_shard, minlength=n_shards)
    m_local = max(int(counts.max()), 1)

    def gather_obs(arr, fill):
        arr = _np(arr)
        out = np.full((n_shards, m_local) + arr.shape[1:], fill, arr.dtype)
        for s in range(n_shards):
            out[s, : counts[s]] = arr[obs_shard == s]
        return out

    # local point index = global - shard offset
    local_point = obs_point - (obs_shard * n_local)
    identity = scene.identity_ext

    def pad_points(arr, fill):
        arr = _np(arr)
        out = np.full((n_shards * n_local,) + arr.shape[1:], fill, arr.dtype)
        out[:N] = arr
        return out.reshape((n_shards, n_local) + arr.shape[1:])

    p, idx = scene.params, scene.index
    return ShardedScene(
        obs_point=gather_obs(local_point.astype(np.int32), 0),
        obs_outer=gather_obs(idx.obs_outer, identity),
        obs_inner=gather_obs(idx.obs_inner, identity),
        obs_intr=gather_obs(idx.obs_intr, 0),
        obs_xy=gather_obs(idx.obs_xy, 0.0),
        obs_mask=gather_obs(idx.obs_mask, 0.0),
        points=pad_points(p.points, 0.0),
        point_mask=pad_points(idx.point_mask, 0.0),
        point_free=pad_points(free.points, 0.0),
        ext_rot=_np(p.ext_rot), ext_trans=_np(p.ext_trans),
        center=_np(p.center), focal=_np(p.focal), dist=_np(p.dist),
        focal_shared=_np(idx.focal_shared), dist_m1=_np(idx.dist_m1),
        dist_m2=_np(idx.dist_m2), cam_free=_np(flatten_camera(free)))


class ShardedResult(NamedTuple):
    points: torch.Tensor     # (S, N_s, 3) refined structure, every shard
    cam_vec: torch.Tensor    # (C,) refined camera vector
    cost: torch.Tensor
    iterations: int
    status: int
    seconds: float = 0.0     # the LM loop's wall clock


class ShardedState(NamedTuple):
    """The loop-carried state of a rank: its shard's points, the
    replicated camera vector, cost and trust region, ``k`` and
    ``status``."""

    points: torch.Tensor
    cam_vec: torch.Tensor
    cost: torch.Tensor
    tr: tr_mod.TRState
    k: int
    status: torch.Tensor


def _local(sharded: ShardedScene, s: int, dtype, device):
    """(cam-table BAParams, SceneIndex, point_free) of shard ``s``."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=device)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    params = BAParams(points=f(sharded.points[s]), ext_rot=f(sharded.ext_rot),
                      ext_trans=f(sharded.ext_trans), center=f(sharded.center),
                      focal=f(sharded.focal), dist=f(sharded.dist))
    index = SceneIndex(
        obs_point=i32(sharded.obs_point[s]), obs_outer=i32(sharded.obs_outer[s]),
        obs_inner=i32(sharded.obs_inner[s]), obs_intr=i32(sharded.obs_intr[s]),
        obs_xy=f(sharded.obs_xy[s]), obs_mask=f(sharded.obs_mask[s]),
        point_mask=f(sharded.point_mask[s]),
        focal_shared=f(sharded.focal_shared), dist_m1=f(sharded.dist_m1),
        dist_m2=f(sharded.dist_m2))
    return params, index, f(sharded.point_free[s])


def solve_ba_sharded(sharded: ShardedScene,
                     options: SolverOptions = SolverOptions(), mesh=None,
                     axis=None, device="cuda", dtype=torch.float64,
                     driver: str = "python") -> ShardedResult:
    """The LM loop with rank r of the group (``mesh`` / ``axis`` as
    ``multihost.reducer_for``; by default the whole world, a one-rank group
    started here if none is) solving shard r of ``sharded``, whose shard
    count must be the group's size. DENSE_SCHUR on the summed reduced
    camera system, at most ``options.max_iterations`` steps; the refined
    points of every shard come back on every rank.

    The step reads nothing on the host (its ``status`` is a device
    tensor). ``driver="python"`` reads the status once an iteration;
    ``driver="while_loop"`` runs the whole solve as one block with no host
    read until it ends (``solver/device_loop.py``; on the card with NCCL
    one CUDA graph, the step's ``all_reduce`` calls inside its WHILE
    node's body; on the CPU, gloo, the same program eagerly), as the
    reference runs it in one ``lax.while_loop``."""
    check_driver(driver)
    device = check_device(device)
    red = reducer_for(device, mesh, axis)
    if sharded.points.shape[0] != red.size:
        raise ValueError(f"{sharded.points.shape[0]} shards for a group of "
                         f"{red.size} ranks")
    cam_template, index, point_free = _local(sharded, red.rank, dtype, device)
    cam_free = torch.as_tensor(sharded.cam_free, dtype=dtype, device=device)
    n_local = cam_template.points.shape[0]
    n_ext_rows = cam_template.ext_rot.shape[0]
    n_intr = cam_template.center.shape[0]
    maps = schur_maps(index, n_local, n_ext_rows, n_intr)

    def params_of(points, cam_vec):
        return dataclasses.replace(unflatten_camera(cam_vec, cam_template),
                                   points=points)

    def total_cost(points, cam_vec):
        return red.sum(cost_fn(params_of(points, cam_vec), index))

    def step(state: ShardedState):
        points, cam_vec, cost, tr = (state.points, state.cam_vec, state.cost,
                                     state.tr)
        blocks = jacobian_blocks_flat(params_of(points, cam_vec), index)
        sys = build_system(blocks.r, blocks.jp, blocks.jc, index, n_local,
                           n_ext_rows, n_intr, cam_free, point_free, maps)
        # assemble the replicated reduced camera system over the group
        g_c = red.sum(sys.g_c)
        sys = sys._replace(g_c=g_c, hcc_diag=red.sum(sys.hcc_diag))
        binv = augmented_point_blocks(sys.hpp, sys.point_free, tr.radius,
                                      options)
        cam_aug = _cam_aug_diag(sys, tr.radius, options)
        # reduced_rhs subtracts the replicated g_c once per shard; add back
        # (S - 1) copies so the sum is -g_c + sum(E^T B^-1 g_p)
        rhs = (red.sum(reduced_rhs(sys, binv))
               + (red.size - 1) * g_c) * cam_free
        S = red.sum(dense_S(sys, binv)) + torch.diag(cam_aug)
        dc = masked_spd_solve(S, rhs, cam_free)
        dp = back_substitute(sys, binv, dc)

        j_dx = j_times(sys, dp, dc)
        mcc = red.sum(tr_mod.model_cost_change(j_dx.reshape(-1),
                                               sys_r(sys).reshape(-1)))
        new_points, new_cam = points + dp, cam_vec + dc
        new_cost = total_cost(new_points, new_cam)
        grad_max = torch.maximum(torch.max(torch.abs(g_c)),
                                 red.max(torch.max(torch.abs(sys.g_p))))
        step_norm = torch.sqrt(red.sum(torch.sum(dp * dp))
                               + torch.dot(dc, dc))
        x_norm = torch.sqrt(red.sum(torch.sum(points * points))
                            + torch.dot(cam_vec, cam_vec))
        accept, tr_next, status, info = tr_mod.decide(
            cost, new_cost, mcc, tr, grad_max, step_norm, x_norm, options)
        return ShardedState(
            points=torch.where(accept, new_points, points),
            cam_vec=torch.where(accept, new_cam, cam_vec), cost=info.cost,
            tr=tr_next, k=state.k + 1, status=status), info

    points, cam_vec = cam_template.points, flatten_camera(cam_template)
    state = ShardedState(
        points=points, cam_vec=cam_vec, cost=total_cost(points, cam_vec),
        tr=tr_mod.init_tr(options.initial_radius, dtype, device), k=0,
        status=torch.zeros((), dtype=torch.int64, device=device))
    if driver == "while_loop":
        loop = BlockLoop(step, ())
        loop.load(state)
        # one block, the whole solve
        k, status, _, seconds = run_blocks(
            loop, 0, options.max_iterations, max(options.max_iterations, 1),
            float("inf"), reducer=red, engine="indexed-sharded")
        state = loop.state
    else:
        # no progress, log, checkpoint or cap, as the one-block driver
        state, k, _, t0 = run_steps(step, (), state, options,
                                    engine="indexed-sharded", reducer=red,
                                    progress=False, max_seconds=math.inf)
        status, seconds = int(state.status), time.time() - t0
    gathered = red.gather_rows(state.points).reshape(
        (red.size,) + tuple(state.points.shape))
    return ShardedResult(points=gathered, cam_vec=state.cam_vec.clone(),
                         cost=state.cost.clone(), iterations=k,
                         status=status, seconds=seconds)

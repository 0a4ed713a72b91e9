"""Sharded dense-grid bundle adjustment: point rows split over the ranks of
a process group, PyTorch port of ``deeparc_tpu.parallel.sharded_grid``.

Each rank holds a contiguous block of the (N points x T cells) grid's rows
(xy, mask, point masks) and of the points, and runs the monolithic grid
kernels (``linearize_grid``, ``cost_grid``; the torch paths under
``impl="planes"`` / ``"einsum"``) on them: H_pp, g_p, the E
coupling rows and the back-substitution are rank-local. Only the small
camera system crosses the group, through the step's reducer
(``solver.rig_grid.make_grid_step(reducer=...)``): g_c (C,), H_cc and the
Schur correction E^T B^-1 E (triangle-packed (C, C)), the reduced rhs (C,)
and a few scalars; at C = 240 in float64 about 0.47 MB a step, whatever
the point count. The trust-region decisions derive from summed scalars,
so every rank takes them together; the wall clock and a checkpoint's
existence are rank 0's, broadcast.

The live-band prep is single-device: the sharded grid runs the monolithic
kernels, as the reference package's sharded grid does.

``driver="while_loop"`` runs the iterations in blocks with no host read
inside a block (``solver/device_loop.py``), as the reference's sharded
solve runs them in ``lax.while_loop`` blocks: on the card with NCCL a
rank's block is one CUDA graph whose WHILE node's body holds the step's
``all_reduce`` calls; on the CPU (gloo) the same program runs eagerly.
A gloo group's collectives on CUDA tensors read the host, which the
block's capture refuses with that reason.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.parallel.multihost import (
    load_checkpoint_shared,
    reducer_for,
)
from deeparc_tpu_torch.residuals.reprojection import flatten_camera
from deeparc_tpu_torch.scene import BAParams
from deeparc_tpu_torch.solver.ba import (
    LM_LOOP,
    BAResult,
    lm_running,
    print_header,
    print_iteration,
    save_checkpoint,
    tr_of,
)
from deeparc_tpu_torch.solver.device_loop import BlockLoop, solve_blocks
from deeparc_tpu_torch.solver.rig_grid import (
    GridIndex,
    _params_from,
    init_grid_state,
    make_grid_step,
    mono_stack,
)
from deeparc_tpu_torch.utils import debug
from deeparc_tpu_torch.utils.logging import log_iteration
from deeparc_tpu_torch.utils.profiling import span


def _pad_rows(t: torch.Tensor, n_pad: int, fill=0.0) -> torch.Tensor:
    if n_pad == 0:
        return t
    return torch.cat([t, t.new_full((n_pad,) + tuple(t.shape[1:]), fill)])


def shard_grid_rows(params: BAParams, grid: GridIndex, point_free,
                    n_shards: int):
    """Pad N to a multiple of ``n_shards``; return (params, grid,
    point_free) with the point-major rows padded (masked) for even
    sharding, plus the unpadded point count. Padded points sit at z = 1
    so the projection chain stays finite."""
    N = int(params.points.shape[0])
    n_pad = -(-N // n_shards) * n_shards - N
    points = _pad_rows(params.points, n_pad)
    if n_pad:
        points[N:, 2] = 1.0
    grid_p = dataclasses.replace(
        grid, xy0=_pad_rows(grid.xy0, n_pad), xy1=_pad_rows(grid.xy1, n_pad),
        mask=_pad_rows(grid.mask, n_pad),
        point_mask=_pad_rows(grid.point_mask, n_pad))
    return (dataclasses.replace(params, points=points), grid_p,
            _pad_rows(point_free, n_pad), N)


def local_rows(n_rows: int, rank: int, n_shards: int) -> slice:
    """Rank ``rank``'s contiguous block of ``n_rows`` (a multiple of
    ``n_shards``) rows."""
    per = n_rows // n_shards
    return slice(rank * per, (rank + 1) * per)


def solve_ba_grid_sharded(params: BAParams, grid: GridIndex, free: BAParams,
                          options: SolverOptions = SolverOptions(),
                          mesh=None, axis=None, chunk_size: int = 8192,
                          checkpoint_path: str | None = None,
                          checkpoint_every: int = 10, resume: bool = False,
                          logger=None, driver: str = "python",
                          while_block: int = 10,
                          impl: str = "auto") -> BAResult:
    """LM to convergence with the points sharded over the ranks of the
    process group (``mesh`` / ``axis`` as ``multihost.reducer_for``; by
    default the whole world, a one-rank group started here if none is).
    Every rank passes the whole problem and gets the whole result: the
    points come back gathered, in their original order. ``impl`` is
    ``solve_ba_grid``'s: the monolithic kernels by default, the torch
    paths for "planes" / "einsum"; each rank runs it on its rows.

    ``driver="python"``: one Python-driven step at a time, like
    ``solve_ba_grid``: the wall-clock cap ``options.max_seconds``
    (``src/sfm.cc:71``) as rank 0 reads it, a solver-state checkpoint every
    ``checkpoint_every`` iterations written by rank 0 (``resume=True``
    restarts from it, rank 0 reading the file), progress lines and
    ``lm_iteration`` log lines from rank 0. ``driver="while_loop"``:
    blocks of up to ``while_block`` steps with no host read inside a
    block; between blocks rank 0's clock applies the cap, and rank 0
    writes the checkpoint (when ``checkpoint_path`` is given) and one
    ``lm_block`` log line; no progress or ``lm_iteration`` lines."""
    if driver not in ("python", "while_loop"):
        raise ValueError(f"unknown driver {driver!r}")
    red = reducer_for(params.points.device, mesh, axis)
    n, rank = red.size, red.rank
    red.check_same([grid.mask.shape[0], grid.mask.shape[1],
                    float(grid.mask.sum()), float(grid.point_mask.sum())],
                   "grids")
    lead = rank == 0
    cam_free = flatten_camera(free)
    params_p, grid_p, pf_p, N = shard_grid_rows(params, grid, free.points, n)
    rows = local_rows(params_p.points.shape[0], rank, n)
    local = dataclasses.replace(
        grid_p, xy0=grid_p.xy0[rows], xy1=grid_p.xy1[rows],
        mask=grid_p.mask[rows], point_mask=grid_p.point_mask[rows], band=())
    point_free = pf_p[rows]
    # the monolithic kernels' plane stack of this rank's rows, once a solve,
    # in solve_ba_grid's tiles
    pxm = mono_stack(local, (min(chunk_size, 256), 1024))
    step = make_grid_step(options, params_p, chunk_size, impl=impl, pxm=pxm,
                          reducer=red)

    def init(p: BAParams):
        """The start state of whole-problem (padded) parameters ``p``."""
        p = dataclasses.replace(p, points=p.points[rows])
        return init_grid_state(p, local, options, impl, pxm=pxm,
                               reducer=red)

    def gathered(st):
        pts = red.gather_rows(st.points)[:N]
        return _params_from(st.cam_vec, pts, params)

    state = init(params_p)
    ck = load_checkpoint_shared(red, checkpoint_path, resume, params)
    if ck is not None:
        ck_params, scal = ck
        state = init(shard_grid_rows(ck_params, grid, free.points, n)[0])
        state = state._replace(tr=tr_of(scal, params.points),
                               k=scal["iteration"])
    if driver == "while_loop":
        return solve_blocks(
            BlockLoop(step, (local, cam_free, point_free)), state, options,
            while_block, checkpoint_path, gathered, red, logger,
            engine="grid-sharded")

    step = debug.checked_step(step, "grid-sharded", red)
    t0 = time.time()
    k = state.k
    if options.progress_to_stdout and lead:
        print_header(k, state.cost)
    with span(LM_LOOP):
        while lm_running(state.status) and k < options.max_iterations:
            if red.agree(time.time() - t0 > options.max_seconds):
                break
            with span("deeparc.lm.step"):
                state, info = step(state, local, cam_free, point_free)
            k += 1
            if options.progress_to_stdout and lead:
                print_iteration(k, info)
            log_iteration(logger if lead else None, k, info)
            if checkpoint_path and k % checkpoint_every == 0:
                ck_params = gathered(state)
                if lead:
                    save_checkpoint(checkpoint_path, ck_params, state.tr, k,
                                    state.cost)
    return BAResult(params=gathered(state), cost=float(state.cost),
                    iterations=k, status=int(state.status),
                    seconds=time.time() - t0)

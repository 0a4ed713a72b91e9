"""Sharded tile-engine bundle adjustment: bucket rows split over the ranks
of a process group, PyTorch port of ``deeparc_tpu.parallel.sharded_tiles``.

The tile engine's point-major layout makes data parallelism plain: each
bucket's rows (and the matching point and freeze rows) are split into
chunk-aligned slices, one per rank, every per-point quantity stays on its
rank, and only the cell-space camera sums cross the group through the
step's reducer (``solver.tiles.make_tile_step(reducer=...)``): the (V, 18)
gradient, the (V, 18, 18) Grams packed to 171 values a cell, the PCG's
(V, 18) rhs and correction bins (once per PCG iteration) and the
trust-region scalars.

A bucket carries tables derived from its rows (the slot bins the kernels
reduce through, the chunk -> cell gather, the row pieces' maps), which a
row slice would make wrong: each rank rebuilds them on its slice
(``solver.tiles.with_bins``), then runs the tile kernels on it.

``driver="while_loop"`` runs the iterations in blocks with no host read
inside a block, PCG included (``solver/device_loop.py``,
``solver.linalg.pcg_device``), as the reference's sharded solve runs them
in ``lax.while_loop`` blocks: on the card with NCCL a rank's block is one
CUDA graph, the step's ``all_reduce`` calls inside its WHILE nodes'
bodies (PCG's nested one included); on the CPU (gloo) the same program
runs eagerly.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.parallel.multihost import (
    load_checkpoint_shared,
    reducer_for,
)
from deeparc_tpu_torch.parallel.sharded_grid import local_rows
from deeparc_tpu_torch.residuals.reprojection import unflatten_camera
from deeparc_tpu_torch.scene import BAParams
from deeparc_tpu_torch.solver.ba import (
    BAResult,
    check_driver,
    run_steps,
    tr_of,
)
from deeparc_tpu_torch.solver.device_loop import BlockLoop, solve_blocks
from deeparc_tpu_torch.solver.tiles import (
    CHUNK_OBS,
    TileBucket,
    TileIndex,
    init_tile_state,
    make_tile_step,
    rows_per_chunk,
    unpermute_points,
    with_bins,
)


def _pad(t: torch.Tensor, pad: int, fill=0.0) -> torch.Tensor:
    return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), fill)])


def shard_tile_rows(params_t: BAParams, tiles: TileIndex, point_free_t,
                    n_shards: int, chunk_obs: int = CHUNK_OBS):
    """Pad every bucket's rows so each splits evenly into ``n_shards``
    chunk-aligned slices, and reorder the row-space point arrays
    SHARD-MAJOR: shard s's contiguous block is [bucket0 slice s | bucket1
    slice s | ... | tail slice s], matching the per-bucket slices
    :func:`local_tiles` gives rank s.

    Returns (params_p, tiles_p, point_free_p, orig_row_of_row) where
    ``orig_row_of_row`` maps the reordered rows back to the caller's rows
    (-1 for padding). ``tiles_p``'s buckets carry no bins: each rank builds
    those on its slice."""
    pts, pf = params_t.points, point_free_t
    dtype, dev = pts.dtype, pts.device
    pad_point = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)

    new_buckets = []
    blocks = []   # per bucket and the tail: (points, free, orig) padded
    offset = 0
    for b in tiles.buckets:
        Nb, W = b.cell.shape
        rpc = (Nb // b.loc[1].shape[0] if b.loc      # loc fixes rows/chunk
               else rows_per_chunk(W, chunk_obs))
        quantum = n_shards * rpc
        pad = -(-Nb // quantum) * quantum - Nb
        loc = ()
        if b.loc:
            local, chunk_cells = b.loc
            loc = (_pad(local, pad, 0), _pad(chunk_cells, pad // rpc, 0))
        new_buckets.append(TileBucket(
            cell=_pad(b.cell, pad, 0), xy0=_pad(b.xy0, pad),
            xy1=_pad(b.xy1, pad), mask=_pad(b.mask, pad), loc=loc))
        blocks.append((
            torch.cat([pts[offset:offset + Nb], pad_point.expand(pad, 3)]),
            _pad(pf[offset:offset + Nb], pad),
            np.concatenate([np.arange(offset, offset + Nb),
                            np.full(pad, -1, dtype=np.int64)])))
        offset += Nb

    # tail rows (zero-track points) pad to the shard count
    tail = pts.shape[0] - offset
    if tail > 0:
        tail_pad = -(-tail // n_shards) * n_shards - tail
        blocks.append((
            torch.cat([pts[offset:], pad_point.expand(tail_pad, 3)]),
            _pad(pf[offset:], tail_pad),
            np.concatenate([np.arange(offset, offset + tail),
                            np.full(tail_pad, -1, dtype=np.int64)])))

    # shard-major interleave
    pts_rows, pf_rows, orig_rows = [], [], []
    for s in range(n_shards):
        for blk_pts, blk_pf, blk_orig in blocks:
            sl = local_rows(blk_pts.shape[0], s, n_shards)
            pts_rows.append(blk_pts[sl])
            pf_rows.append(blk_pf[sl])
            orig_rows.append(blk_orig[sl])
    params_p = dataclasses.replace(params_t, points=torch.cat(pts_rows))
    tiles_p = TileIndex(cells=tiles.cells, buckets=tuple(new_buckets),
                        row_of_point=tiles.row_of_point)
    return params_p, tiles_p, torch.cat(pf_rows), np.concatenate(orig_rows)


def local_tiles(tiles_p: TileIndex, rank: int, n_shards: int) -> TileIndex:
    """Rank ``rank``'s slice of every bucket of a :func:`shard_tile_rows`
    layout, with the bins and maps its kernels and sums need rebuilt on
    the slice (the chunk tables are sliced whole chunks at a time)."""
    V = tiles_p.cells.cols.shape[0]
    buckets = []
    for b in tiles_p.buckets:
        sl = local_rows(b.cell.shape[0], rank, n_shards)
        loc = ()
        if b.loc:
            local, chunk_cells = b.loc
            loc = (local[sl], chunk_cells[local_rows(chunk_cells.shape[0],
                                                     rank, n_shards)])
        buckets.append(with_bins(TileBucket(
            cell=b.cell[sl], xy0=b.xy0[sl], xy1=b.xy1[sl], mask=b.mask[sl],
            loc=loc), V))
    return TileIndex(cells=tiles_p.cells, buckets=tuple(buckets),
                     row_of_point=tiles_p.row_of_point)


def layout_signature(tiles: TileIndex, n_rows: int) -> list:
    """Shapes and checksums of a tile layout, for the ranks to compare."""
    out = [tiles.cells.cols.shape[0], n_rows,
           float(tiles.cells.cols.sum())]
    for b in tiles.buckets:
        out += [*b.cell.shape, float(b.cell.sum()), float(b.mask.sum()),
                b.loc[1].shape[1] if b.loc else 0]
    return out


def solve_ba_tiles_sharded(params_t: BAParams, tiles: TileIndex,
                           point_free_t, cam_free,
                           options: SolverOptions = SolverOptions(),
                           mesh=None, axis=None, chunk_obs: int = CHUNK_OBS,
                           checkpoint_path: str | None = None,
                           checkpoint_every: int = 10, resume: bool = False,
                           logger=None, sweep_dtype=None,
                           driver: str = "python",
                           while_block: int = 10,
                           impl: str = "auto") -> BAResult:
    """Tile-engine LM to convergence with the bucket rows sharded over the
    ranks of the process group (``mesh`` / ``axis`` as
    ``multihost.reducer_for``; by default the whole world, a one-rank group
    started here if none is).

    Inputs are the caller's ROW-SPACE arrays (``tiles_from_scene``), the
    same on every rank; each rank pads and slices them
    (:func:`shard_tile_rows`, :func:`local_tiles`). Returns a BAResult in
    the caller's row space, gathered on every rank. ``impl`` is
    ``make_tile_step``'s: the kernels by default, "xla" the torch paths.

    ``driver="python"``: one Python-driven step at a time, like
    ``solve_tiles_prepared``: the wall-clock cap ``options.max_seconds``
    (``src/sfm.cc:71``) as rank 0 reads it, a checkpoint (points in
    original order) every ``checkpoint_every`` iterations written by rank
    0 (``resume=True`` restarts from it, rank 0 reading the file),
    progress lines and ``lm_iteration`` log lines from rank 0.
    ``driver="while_loop"``: blocks of up to ``while_block`` steps, PCG
    included, with no host read inside a block; between blocks rank 0's
    clock applies the cap, and rank 0 writes the checkpoint (when
    ``checkpoint_path`` is given) and one ``lm_block`` log line; no
    progress or ``lm_iteration`` lines."""
    check_driver(driver)
    red = reducer_for(params_t.points.device, mesh, axis)
    n, rank = red.size, red.rank
    red.check_same(layout_signature(tiles, params_t.points.shape[0]),
                   "tile layouts")
    params_p, tiles_p, pf_p, orig_rows = shard_tile_rows(
        params_t, tiles, point_free_t, n, chunk_obs)
    # the shard-major rows that hold the caller's rows, and which those are
    dev = params_t.points.device
    kept = torch.as_tensor(np.nonzero(orig_rows >= 0)[0], device=dev)
    dest = torch.as_tensor(orig_rows[orig_rows >= 0], device=dev)
    rows = local_rows(params_p.points.shape[0], rank, n)
    local = local_tiles(tiles_p, rank, n)
    point_free = pf_p[rows]
    step = make_tile_step(options, params_p, impl, sweep_dtype=sweep_dtype,
                          reducer=red, device_loop=driver == "while_loop")

    def init(p: BAParams):
        """The start state of shard-major parameters ``p``."""
        p = dataclasses.replace(p, points=p.points[rows])
        return init_tile_state(p, local, options, cam_free, reducer=red)

    def row_space(st) -> BAParams:
        points = torch.empty_like(params_t.points)
        points[dest] = red.gather_rows(st.points)[kept]
        out = unflatten_camera(st.cam_vec, params_t)
        return dataclasses.replace(out, points=points)

    state = init(params_p)
    ck = load_checkpoint_shared(red, checkpoint_path, resume, params_t)
    if ck is not None:
        # checkpoints hold points in original order; padding keeps the
        # values shard_tile_rows gave it
        ck_params, scal = ck
        caller = params_t.points.clone()
        caller[tiles.row_of_point.long()] = ck_params.points
        points = params_p.points.clone()
        points[kept] = caller[dest]
        state = init(dataclasses.replace(ck_params, points=points))._replace(
            tr=tr_of(scal, params_t.points), k=scal["iteration"])

    def original(st) -> BAParams:
        """The gathered parameters, points in the caller's original
        order (the checkpoint's)."""
        out = row_space(st)
        return dataclasses.replace(out, points=unpermute_points(out.points,
                                                                tiles))

    if driver == "while_loop":
        # the result in the caller's row space, as the Python driver's
        return solve_blocks(
            BlockLoop(step, (local, cam_free, point_free)), state, options,
            while_block, checkpoint_path, original, red, logger,
            result=row_space, engine="tiles-sharded")

    state, k, cg_total, t0 = run_steps(
        step, (local, cam_free, point_free), state, options,
        engine="tiles-sharded", checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, original=original, logger=logger,
        cg=True, reducer=red)
    return BAResult(params=row_space(state), cost=float(state.cost),
                    iterations=k, status=int(state.status),
                    seconds=time.time() - t0, cg_iterations=cg_total)

"""Tile engine: bundle adjustment for arbitrary camera graphs (BAL-style
scenes, the reference's non-shared mode: ``src/ParameterBlock.hh:52-55``
column semantics + ``src/sfm.cc:67`` Schur over an arbitrary camera-point
bipartite graph), PyTorch port of ``deeparc_tpu.solver.tiles``.

Layout (built on the host, identical to the reference's):
  * point-major dense rows: the observations of one point form one padded
    row of W slots (W = next power of two >= track length); points are
    bucketed by W, and each bucket is a contiguous slice of the permuted
    point rows, so every per-point reduction is a within-row sum;
  * a cell table: the distinct (outer, inner, intrinsic) triples form V
    cells, whose camera values are packed into one (V, 78) table;
  * locality blocking: cells are renumbered by co-visibility (RCM, hub
    stripping, a spectral cyclic order), rows are ordered by their mean
    cell, and each chunk of B rows gets a small local cell table, so the
    kernels look up and bin against V_local << V cells.

Each LM step linearizes every bucket, solves the reduced camera system
matrix-free by PCG (ITERATIVE_SCHUR with block-Jacobi) whose matvec is one
sweep over the observations, back-substitutes the points and evaluates the
trial cost, under the same Ceres trust-region law as the other engines.
``impl`` picks the linearize and the sweeps, with the reference's names:

  * ``"auto"`` / ``"pallas"``: the fused ``tile_linearize_local`` kernel
    for narrow locality-blocked buckets, the torch chunk path for the rest;
    sweeps through ``tile_sweep_local`` / ``tile_sweep`` for buckets of
    width <= 64, the torch sweeps for wider ones. The tensors' device picks
    the hand kernels (CUDA) or their plain versions (CPU); the routing is
    the same on both;
  * ``"xla"``: the torch chunk path and the torch sweeps for every bucket
    (each slot's cell values gathered by its cell id, the slot rows summed
    into the cells in a fixed order).

The reference's ``"dual"`` (camera-major sweeps) is not ported: timed on
the H100 it lost to the kernel sweeps (``PERF.md``), so it raises.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.kernels.tile import (
    MAX_KERNEL_WIDTH,
    MAX_LIN_WIDTH,
    chunk_gather,
    gather_map,
    pack_bucket_planes,
    slot_bins,
    sort_jcam,
    sort_jcam_planes,
    sum_chunk_bins,
    sum_rows,
    tile_linearize_local,
    tile_sweep,
    tile_sweep_local,
)
from deeparc_tpu_torch.residuals.reprojection import (
    flatten_camera,
    unflatten_camera,
)
from deeparc_tpu_torch.scene import BAParams, Scene, _np
from deeparc_tpu_torch.solver import trust_region as tr_mod
from deeparc_tpu_torch.solver.ba import (
    LM_LOOP,
    BAResult,
    StepInfo,
    lm_running,
    load_checkpoint,
    print_header,
    print_iteration,
    save_checkpoint,
    tr_of,
)
from deeparc_tpu_torch.solver.linalg import pcg, pcg_device
from deeparc_tpu_torch.solver.loss import rho as loss_rho
from deeparc_tpu_torch.solver.loss import weight as loss_weight
from deeparc_tpu_torch.solver.rig_grid import (
    KERNEL_IMPLS,
    reductions,
    slot_params,
)
from deeparc_tpu_torch.solver.schur import augmented_point_blocks
from deeparc_tpu_torch.utils import debug
from deeparc_tpu_torch.utils.logging import log_iteration
from deeparc_tpu_torch.utils.profiling import span, traced

# target observations per chunk: rows-per-chunk = CHUNK_OBS // W
CHUNK_OBS = 8192
# slots the torch chunk path processes at once (bounds its temporaries)
_PIECE_SLOTS = 1 << 18
# most slots of one cell in a piece that one block of the gather kernel
# sums; a hub cell's thousands are cut into segments (gather_map)
_PIECE_SEGMENT = 512


def rows_per_chunk(width: int, chunk_obs: int = CHUNK_OBS) -> int:
    return max(chunk_obs // width, 1)


class CellTable(NamedTuple):
    """Distinct camera-slot triples (the "virtual cameras" of the scene),
    duck-typed to what ``rig_grid.slot_params`` reads."""

    slot_outer: torch.Tensor    # (V,) int32 extrinsic row ids
    slot_inner: torch.Tensor    # (V,)
    slot_intr: torch.Tensor     # (V,)
    focal_shared: torch.Tensor  # (V,)
    dist_m1: torch.Tensor       # (V,)
    dist_m2: torch.Tensor       # (V,)
    cols: torch.Tensor          # (V, 18) flat camera-vector column ids
    maps: tuple = ()            # (flat, block6): the fixed-order maps of
                                # cells_to_flat and _block_jacobi


def cell_maps(cols: torch.Tensor, C: int) -> tuple:
    """The fixed-order maps (:func:`kernels.tile.gather_map`) of the
    step's two cell -> camera sums into the (C,) camera vector, built once
    per layout: ``flat`` takes the (V, 18) cell values (source v * 18 + j)
    to the C flat camera columns (:func:`cells_to_flat`), ``block6`` the
    cells' three diagonal 6x6 blocks (source j * V + v for block j) to the
    C / 6 blocks of 6 rows (:func:`_block_jacobi`)."""
    return (gather_map(cols.reshape(-1), C),
            gather_map(_block_rows(cols), C // 6))


def _block_rows(cols: torch.Tensor) -> torch.Tensor:
    """The 6-row block of each cell's three diagonal blocks, block-major
    (the order of the block-Jacobi's sources)."""
    return (cols[:, 0::6] // 6).T.reshape(-1)


class TileBucket(NamedTuple):
    """Points whose padded track length is W, as dense (Nb, W) planes.

    ``loc`` is the optional locality blocking: (local (Nb, W) int32 in
    [0, V_local), chunk_cells (n_chunks, V_local) int32 global cell id per
    local slot), or (). ``bins`` is the :class:`kernels.tile.SlotBins` of
    the plane the kernels bin through (local ids when ``loc``, else global
    ids), or () where the bucket is too wide for the kernels. ``pieces``
    holds, per row piece of the torch chunk path (:func:`_row_pieces`),
    the fixed-order map (:func:`kernels.tile.gather_map`) of the piece's
    slots to the global cells, by which that path and the torch sweeps sum
    their slot rows into the cells on the card; it leaves out the slots
    masked when it is built, whose rows are zero (masks only fall)."""

    cell: torch.Tensor  # (Nb, W) int32 GLOBAL cell id per slot (0 if masked)
    xy0: torch.Tensor   # (Nb, W) observed pixel x
    xy1: torch.Tensor   # (Nb, W)
    mask: torch.Tensor  # (Nb, W) 1.0 = observed
    loc: tuple = ()
    bins: tuple = ()
    pieces: tuple = ()


class TileIndex(NamedTuple):
    cells: CellTable
    buckets: tuple                 # tuple[TileBucket, ...]
    row_of_point: torch.Tensor     # (N_orig,) permuted+padded row per point


# ---------------------------------------------------------------------------
# Host-side layout (numpy/scipy, the reference's code)
# ---------------------------------------------------------------------------


def _locality_cell_order(cell_of_obs, pts_of_obs, V0, N):
    """Cell permutation for chunk locality: reverse Cuthill-McKee on the
    cell co-visibility graph with 'hub' cells (co-visible with a large
    fraction of all cells) stripped first and appended at the end, raced
    against a spectral cyclic order by p99 cyclic bandwidth. Returns
    ``(perm, hub_mask_or_None)`` with perm mapping new rank -> old id."""
    import scipy.sparse as _sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = _sp.coo_matrix(
        (np.ones(cell_of_obs.size, np.float32),
         (cell_of_obs, pts_of_obs)), shape=(V0, N)).tocsr()
    G = (A @ A.T).tocsr()
    deg = np.diff(G.indptr).astype(np.int64)
    med = max(float(np.median(deg)), 1.0)
    hub_mask = deg > np.maximum(2.0 * med, 0.5 * V0)
    if hub_mask.any() and hub_mask.sum() < 0.2 * V0:
        keep = np.nonzero(~hub_mask)[0]
    else:
        keep = np.arange(V0)
        hub_mask = None
    Gs = G[keep][:, keep].tocsr()

    cands = [np.asarray(
        reverse_cuthill_mckee(Gs, symmetric_mode=True), np.int64)]
    k = keep.size
    if 4 <= k <= 4096:
        a = np.asarray(Gs.todense(), np.float64)
        d = np.maximum(a.sum(axis=1), 1e-9)
        a = a / np.sqrt(d[:, None] * d[None, :])
        try:
            _, vecs = np.linalg.eigh(a)
            cands.append(np.argsort(
                np.arctan2(vecs[:, -3], vecs[:, -2])).astype(np.int64))
        except np.linalg.LinAlgError:
            pass

    Gc = Gs.tocoo()
    nz = Gc.row != Gc.col

    def cyc_band(sub):
        rank = np.empty(k, np.int64)
        rank[sub] = np.arange(k)
        dd = np.abs(rank[Gc.row[nz]] - rank[Gc.col[nz]])
        dd = np.minimum(dd, k - dd)
        return float(np.percentile(dd, 99)) if dd.size else 0.0

    sub = min(cands, key=cyc_band)
    if hub_mask is not None:
        return (np.concatenate([keep[sub], np.nonzero(hub_mask)[0]]),
                hub_mask)
    return keep[sub], None


def _order_chunk_width(members_sorted, rpc, pts_of_obs, cell_of_obs,
                       sel_mask, N, V):
    """Max distinct cells any rpc-row chunk touches under this member
    order (the exact v_local the chunk tables would get, pre-pow2)."""
    if members_sorted.size == 0:
        return 0
    rank = np.full(N, -1, np.int64)
    rank[members_sorted] = np.arange(members_sorted.size)
    chunk = rank[pts_of_obs[sel_mask]] // rpc
    pairs = np.unique(chunk * np.int64(V) + cell_of_obs[sel_mask])
    return int(np.bincount(pairs // V).max())


def bucket_with_local(bucket: TileBucket, rows_chunk: int,
                      v_local_max: int | None = None,
                      min_v_local: int = 8) -> TileBucket:
    """Attach exact per-chunk local cell tables to a bucket (host-side).

    V_local = the per-bucket max of distinct cells in any chunk of
    ``rows_chunk`` rows, rounded up to a power of two (>= 8). If that
    exceeds ``v_local_max`` (default: half the chunk's slot count) the
    bucket is returned without ``loc``."""
    cell = _np(bucket.cell)
    Nb, W = cell.shape
    if Nb % rows_chunk:
        raise ValueError(f"{Nb} rows are not a multiple of {rows_chunk}")
    n_chunks = Nb // rows_chunk
    uniqs = [np.unique(cell[c * rows_chunk:(c + 1) * rows_chunk])
             for c in range(n_chunks)]
    max_u = max((u.size for u in uniqs), default=1)
    v_local = max(min_v_local, 1 << (max_u - 1).bit_length())
    if v_local_max is None:
        v_local_max = max(rows_chunk * W // 2, min_v_local)
    if v_local > v_local_max:
        return bucket._replace(loc=(), bins=(), pieces=())
    local = np.zeros((Nb, W), np.int32)
    chunk_cells = np.zeros((n_chunks, v_local), np.int32)
    for c, u in enumerate(uniqs):
        sl = slice(c * rows_chunk, (c + 1) * rows_chunk)
        chunk_cells[c, : u.size] = u
        local[sl] = np.searchsorted(u, cell[sl]).astype(np.int32)
    dev = bucket.cell.device
    return bucket._replace(loc=(torch.as_tensor(local, device=dev),
                                torch.as_tensor(chunk_cells, device=dev)),
                           bins=(), pieces=())


def with_bins(bucket: TileBucket, V: int) -> TileBucket:
    """The bucket with the slot bins its kernels reduce through (local ids
    when it has ``loc``, with the fixed-order map of its chunk bins to the
    V global cells; else global ids; () when it is wider than the kernels
    take) and the fixed-order maps of its row pieces on the torch chunk
    path, without the masked slots (padding would pile onto cell 0)."""
    Nb, W = bucket.cell.shape
    live_cell = torch.where(bucket.mask > 0.5, bucket.cell, -1)
    bucket = bucket._replace(pieces=tuple(
        gather_map(live_cell[r0:r1], V, _PIECE_SEGMENT)
        for r0, r1 in _row_pieces(Nb, W)))
    if W > MAX_KERNEL_WIDTH:
        return bucket._replace(bins=())
    if bucket.loc:
        local, chunk_cells = bucket.loc
        bins = slot_bins(local.T, chunk_cells.shape[0], chunk_cells.shape[1])
        bins = bins._replace(gather=chunk_gather(bins, chunk_cells, V))
    else:
        bins = slot_bins(bucket.cell.T, 1, V)
    return bucket._replace(bins=bins)


def tiles_from_scene(scene: Scene, free: BAParams | None = None,
                     min_width: int = 4, chunk_obs: int = CHUNK_OBS,
                     dtype=None, locality: bool = True,
                     v_local_max: int | None = None,
                     with_slot_src: bool = False):
    """Build the tile layout from any Scene (shared rig or BAL-style), on
    the scene's device.

    Returns ``(tiles, params_t, free_points_t)`` (plus per-bucket
    ``slot_src`` (Nb_pad, W) original observation ids, -1 on empty slots,
    when ``with_slot_src``) where ``params_t.points`` and the point freeze
    mask live in PERMUTED + PADDED row space: bucket b's rows follow
    bucket b-1's, each bucket is padded to a multiple of its rows-per-chunk
    with dead rows (mask 0, point at (0, 0, 1)), and zero-track points sit
    in a tail slice. :func:`unpermute_points` maps results back."""
    dtype = dtype or scene.params.points.dtype
    dev = scene.params.points.device
    idx = scene.index
    obs_point = _np(idx.obs_point)
    obs_alive = (_np(idx.obs_mask) > 0.5) & (
        _np(idx.point_mask)[obs_point] > 0.5)
    outer = _np(idx.obs_outer)[obs_alive]
    inner = _np(idx.obs_inner)[obs_alive]
    intr = _np(idx.obs_intr)[obs_alive]
    xy = _np(idx.obs_xy)[obs_alive]
    pts_of_obs = obs_point[obs_alive]
    N = scene.n_points
    R_rows = scene.params.ext_rot.shape[0]
    C = 6 * R_rows + 6 * scene.params.center.shape[0]
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                  device=dev)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)

    # --- cells: unique (outer, inner, intr) triples, RCM-renumbered -------
    triples = np.stack([outer, inner, intr], axis=1)
    cells_np, cell_of_obs = np.unique(triples, axis=0, return_inverse=True)
    cell_of_obs = cell_of_obs.reshape(-1)
    hub_cell = None
    if locality and cells_np.shape[0] > 2:
        V0 = cells_np.shape[0]
        perm, hub_mask = _locality_cell_order(cell_of_obs, pts_of_obs,
                                              V0, N)
        rank_v = np.empty(V0, np.int64)
        rank_v[perm] = np.arange(V0)
        cells_np = cells_np[perm]
        cell_of_obs = rank_v[cell_of_obs]
        if hub_mask is not None and hub_mask.any():
            hub_cell = rank_v[np.nonzero(hub_mask)[0]]
    six = np.arange(6)
    cols = np.concatenate([
        cells_np[:, 0:1] * 6 + six,
        cells_np[:, 1:2] * 6 + six,
        6 * R_rows + cells_np[:, 2:3] * 6 + six,
    ], axis=1).astype(np.int32)
    cells = CellTable(
        slot_outer=i32(cells_np[:, 0]), slot_inner=i32(cells_np[:, 1]),
        slot_intr=i32(cells_np[:, 2]),
        focal_shared=f(_np(idx.focal_shared)[cells_np[:, 2]]),
        dist_m1=f(_np(idx.dist_m1)[cells_np[:, 2]]),
        dist_m2=f(_np(idx.dist_m2)[cells_np[:, 2]]),
        cols=i32(cols), maps=cell_maps(i32(cols), C))

    # --- bucket points by padded track length -----------------------------
    track = np.bincount(pts_of_obs, minlength=N).astype(np.int64)
    width = np.maximum(
        min_width,
        1 << np.ceil(np.log2(np.maximum(track, 1))).astype(np.int64))
    width[track == 0] = 0

    order = np.argsort(pts_of_obs, kind="stable")
    sorted_pts = pts_of_obs[order]
    starts = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(track, out=starts[1:])
    slot_of_sorted = np.arange(order.size, dtype=np.int64) - starts[sorted_pts]

    widths = sorted(int(w) for w in np.unique(width) if w > 0)
    buckets = []
    row_of_point = np.zeros(N, dtype=np.int64)
    points_rows, free_rows = [], []
    pts_np = _np(scene.params.points)
    pfree_np = (_np(free.points) if free is not None
                else _np(idx.point_mask)[:, None] * np.ones((1, 3)))
    pad_point = np.array([0.0, 0.0, 1.0])
    rank = np.full(N, -1, dtype=np.int64)
    alive_idx = np.nonzero(obs_alive)[0]
    slot_srcs = []
    # locality keys: the (hub-free) mean cell of each point's observations,
    # and its circular mean; per bucket the one with narrower chunk tables
    V_cells = cells_np.shape[0]
    if hub_cell is not None:
        w_obs = (~np.isin(cell_of_obs, hub_cell)).astype(np.float64)
    else:
        w_obs = np.ones(cell_of_obs.shape[0])
    cell_sum = np.zeros(N)
    np.add.at(cell_sum, pts_of_obs, cell_of_obs * w_obs)
    w_cnt = np.zeros(N)
    np.add.at(w_cnt, pts_of_obs, w_obs)
    all_sum = np.zeros(N)
    np.add.at(all_sum, pts_of_obs, cell_of_obs.astype(np.float64))
    mean_cell = np.where(w_cnt > 0, cell_sum / np.maximum(w_cnt, 1),
                         all_sum / np.maximum(track, 1))
    ang = 2.0 * np.pi * cell_of_obs / max(V_cells, 1)
    sin_sum = np.zeros(N)
    cos_sum = np.zeros(N)
    np.add.at(sin_sum, pts_of_obs, np.sin(ang) * w_obs)
    np.add.at(cos_sum, pts_of_obs, np.cos(ang) * w_obs)
    theta_cell = np.arctan2(sin_sum, cos_sum)
    offset = 0
    for W in widths:
        members = np.nonzero(width == W)[0]
        rpc = rows_per_chunk(W, chunk_obs)
        if locality:
            sel_mask = width[pts_of_obs] == W
            cands = [
                members[np.argsort(mean_cell[members], kind="stable")],
                members[np.argsort(theta_cell[members], kind="stable")],
            ]
            members = min(cands, key=lambda m: _order_chunk_width(
                m, rpc, pts_of_obs, cell_of_obs, sel_mask, N, V_cells))
        Nb = members.size
        Nb_pad = -(-Nb // rpc) * rpc
        rank[members] = np.arange(Nb)

        sel = np.nonzero(width[sorted_pts] == W)[0]
        rows = rank[sorted_pts[sel]]
        slots = slot_of_sorted[sel]
        src = order[sel]

        cell_b = np.zeros((Nb_pad, W), dtype=np.int32)
        xy0_b = np.zeros((Nb_pad, W))
        xy1_b = np.zeros((Nb_pad, W))
        mask_b = np.zeros((Nb_pad, W))
        cell_b[rows, slots] = cell_of_obs[src]
        xy0_b[rows, slots] = xy[src, 0]
        xy1_b[rows, slots] = xy[src, 1]
        mask_b[rows, slots] = 1.0
        if with_slot_src:
            src_b = np.full((Nb_pad, W), -1, dtype=np.int64)
            src_b[rows, slots] = alive_idx[src]
            slot_srcs.append(src_b)

        row_of_point[members] = offset + np.arange(Nb)
        points_rows.append(np.concatenate(
            [pts_np[members], np.tile(pad_point, (Nb_pad - Nb, 1))]))
        free_rows.append(np.concatenate(
            [pfree_np[members], np.zeros((Nb_pad - Nb, 3))]))
        bucket = TileBucket(cell=i32(cell_b), xy0=f(xy0_b), xy1=f(xy1_b),
                            mask=f(mask_b))
        if locality:
            bucket = bucket_with_local(bucket, rpc, v_local_max)
        buckets.append(with_bins(bucket, V_cells))
        offset += Nb_pad

    tail = np.nonzero(width == 0)[0]
    if tail.size:
        row_of_point[tail] = offset + np.arange(tail.size)
        points_rows.append(pts_np[tail])
        free_rows.append(np.zeros((tail.size, 3)))
        offset += tail.size

    points_t = f(np.concatenate(points_rows) if points_rows
                 else np.zeros((1, 3)))
    free_t = f(np.concatenate(free_rows) if free_rows else np.zeros((1, 3)))
    tiles = TileIndex(cells=cells, buckets=tuple(buckets),
                      row_of_point=i32(row_of_point))
    params_t = dataclasses.replace(scene.params, points=points_t)
    if with_slot_src:
        return tiles, params_t, free_t, tuple(slot_srcs)
    return tiles, params_t, free_t


def unpermute_points(points_t: torch.Tensor, tiles: TileIndex) -> torch.Tensor:
    """Map permuted+padded row space back to original point order."""
    return points_t[tiles.row_of_point.long()]


# ---------------------------------------------------------------------------
# Packed cell table and the torch chunk path
# ---------------------------------------------------------------------------

# packed layout: R_i 0:9 | R_o 9:18 | R_oi 18:27 | t_i 27:30 | t_o 30:33 |
# Jr_o 33:42 | Jr_i 42:51 | center 51:53 | fx 53 | fy 54 | d0 55 | d1 56 |
# fs 57 | m1 58 | m2 59 | free18 60:78


def pack_cells(sp, cells: CellTable, cam_free: torch.Tensor) -> torch.Tensor:
    """(V, 78) packed per-cell derived parameters + freeze columns."""
    V = cells.slot_outer.shape[0]
    dtype = sp.fx.dtype
    free18 = cam_free[cells.cols.long()]
    parts = [
        sp.R_i.reshape(V, 9), sp.R_o.reshape(V, 9), sp.R_oi.reshape(V, 9),
        sp.t_i, sp.t_o, sp.Jr_o.reshape(V, 9), sp.Jr_i.reshape(V, 9),
        sp.center, sp.fx[:, None], sp.fy[:, None],
        sp.d0[:, None], sp.d1[:, None],
        cells.focal_shared[:, None], cells.dist_m1[:, None],
        cells.dist_m2[:, None], free18,
    ]
    return torch.cat([p.to(dtype) for p in parts], dim=1)


def _unpack(sl: torch.Tensor) -> dict:
    """Gathered table rows (..., 78) -> dict of per-slot tensors."""
    shp = sl.shape[:-1]

    def t(a, b, shape=None):
        return sl[..., a:b].reshape(shp + (shape or (b - a,)))

    return dict(
        R_i=t(0, 9, (3, 3)), R_o=t(9, 18, (3, 3)), R_oi=t(18, 27, (3, 3)),
        t_i=t(27, 30), t_o=t(30, 33),
        Jr_o=t(33, 42, (3, 3)), Jr_i=t(42, 51, (3, 3)),
        center=t(51, 53), fx=sl[..., 53], fy=sl[..., 54],
        d0=sl[..., 55], d1=sl[..., 56], fs=sl[..., 57], m1=sl[..., 58],
        m2=sl[..., 59], free18=t(60, 78))


def _project_chunk(pts, c, xy0, xy1, mask):
    """Residual chain for (B, W) slots with per-slot camera values (the
    closed form of ``src/snavely_reprojection_error.hh:38-118``)."""
    p2 = torch.einsum("bwij,bj->bwi", c["R_i"], pts) + c["t_i"]
    p3 = torch.einsum("bwij,bwj->bwi", c["R_o"], p2) + c["t_o"]
    # masked slots carry the pad cell; keep z away from 0 for them
    z = torch.where(mask > 0.5, p3[..., 2], torch.ones_like(p3[..., 2]))
    inv_z = 1.0 / z
    u = p3[..., :2] * inv_z[..., None]
    r2 = torch.sum(u * u, dim=-1)
    dcoef = 1.0 + r2 * (c["d0"] + c["d1"] * r2)
    f2 = torch.stack([c["fx"], c["fy"]], dim=-1)
    pred = f2 * dcoef[..., None] * u + c["center"]
    r = (pred - torch.stack([xy0, xy1], dim=-1)) * mask[..., None]
    return dict(p2=p2, inv_z=inv_z, u=u, r2=r2, dcoef=dcoef, f2=f2, r=r)


def _cross(v):
    """[v]_x for (..., 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zr = torch.zeros_like(x)
    return torch.stack([torch.stack([zr, -z, y], -1),
                        torch.stack([z, zr, -x], -1),
                        torch.stack([-y, x, zr], -1)], dim=-2)


def _linearize_chunk(pts, c, xy0, xy1, mask, point_free, loss, loss_scale):
    """Closed-form Jacobian blocks of (B, W) slots (masked + freeze-masked).

    Returns (cost, r (B,W,2), j_x (B,W,2,3), j_cam (B,W,2,18), g_p (B,3),
    hpp (B,3,3)); rotation derivatives via d(R(w) v)/dw = -R(w) [v]_x
    J_r(w), matching Ceres' Jets through the angle-axis parameterization."""
    pc = _project_chunk(pts, c, xy0, xy1, mask)
    u, inv_z, r2, dcoef, f2 = (pc["u"], pc["inv_z"], pc["r2"], pc["dcoef"],
                               pc["f2"])
    r = pc["r"]
    raw_s = torch.sum(r * r, dim=-1)
    cost = 0.5 * torch.sum(loss_rho(raw_s, loss, loss_scale) * mask)
    mfac = mask
    if loss != "trivial":
        w = loss_weight(raw_s, loss, loss_scale)
        r = r * w[..., None]
        mfac = mask * w

    zero = torch.zeros_like(inv_z)
    du_dp = torch.stack([
        torch.stack([inv_z, zero, -u[..., 0] * inv_z], dim=-1),
        torch.stack([zero, inv_z, -u[..., 1] * inv_z], dim=-1),
    ], dim=-2)                                            # (B, W, 2, 3)
    ddcoef = c["d0"] + 2.0 * c["d1"] * r2
    dr2_dp = 2.0 * torch.einsum("bwk,bwka->bwa", u, du_dp)
    dres_dp = f2[..., None] * (
        dcoef[..., None, None] * du_dp
        + u[..., None] * (ddcoef[..., None] * dr2_dp)[..., None, :])
    dres_dp = dres_dp * mfac[..., None, None]

    j_x = torch.einsum("nwka,nwab->nwkb", dres_dp, c["R_oi"])
    j_to = dres_dp
    j_ti = torch.einsum("nwka,nwab->nwkb", dres_dp, c["R_o"])
    dp3_dwo = -torch.einsum("bwij,bwjk,bwkl->bwil", c["R_o"],
                            _cross(pc["p2"]), c["Jr_o"])
    j_wo = torch.einsum("nwka,nwab->nwkb", dres_dp, dp3_dwo)
    dp3_dwi = -torch.einsum("bwij,bjk,bwkl->bwil", c["R_oi"], _cross(pts),
                            c["Jr_i"])
    j_wi = torch.einsum("nwka,nwab->nwkb", dres_dp, dp3_dwi)

    # intrinsics: [cx, cy, f0, f1, d0, d1]
    eye2 = torch.eye(2, dtype=r.dtype, device=r.device)
    j_center = eye2.expand(r.shape + (2,)) * mfac[..., None, None]
    du_term = dcoef[..., None] * u
    sh = c["fs"] > 0.5
    zr2 = torch.zeros_like(r2)
    j_f0 = torch.stack([du_term[..., 0],
                        torch.where(sh, du_term[..., 1], zr2)], dim=-1)
    j_f1 = torch.stack([zr2, torch.where(sh, zr2, du_term[..., 1])], dim=-1)
    j_focal = torch.stack([j_f0, j_f1], dim=-1) * mfac[..., None, None]
    fu = f2 * u
    j_d0 = fu * (r2 * c["m1"])[..., None]
    j_d1 = fu * (r2 * r2 * c["m2"])[..., None]
    j_dist = torch.stack([j_d0, j_d1], dim=-1) * mfac[..., None, None]
    j_intr = torch.cat([j_center, j_focal, j_dist], dim=-1)

    j_cam = torch.cat([j_wo, j_to, j_wi, j_ti, j_intr], dim=-1)
    j_cam = j_cam * c["free18"][:, :, None, :]
    j_x = j_x * point_free[:, None, None, :]

    g_p = torch.einsum("bwki,bwk->bi", j_x, r)
    hpp = torch.einsum("bwki,bwkj->bij", j_x, j_x)
    return cost, r, j_x, j_cam, g_p, hpp


class BucketBlocks(NamedTuple):
    r: torch.Tensor      # (Nb, W, 2) masked (+loss-weighted) residuals
    j_x: torch.Tensor    # (Nb, W, 2, 3) point-freeze-masked
    j_cam: torch.Tensor  # (Nb, W, 2, 18) camera-freeze-masked


class TileSystem(NamedTuple):
    cost: torch.Tensor
    g_p: torch.Tensor        # (Nrows, 3)
    hpp: torch.Tensor        # (Nrows, 3, 3)
    g_c: torch.Tensor        # (C,)
    hcc_cells: torch.Tensor  # (V, 18, 18)
    hcc_diag: torch.Tensor   # (C,)
    blocks: tuple            # per bucket: BucketBlocks, or None (fused)


@functools.lru_cache(maxsize=None)
def _triu18(device: torch.device) -> torch.Tensor:
    """np.triu_indices(18) as a (2, 171) tensor made on ``device`` (numpy
    indices would be copied from the host at every use)."""
    return torch.triu_indices(18, 18, device=device)


def _sym_pack(h: torch.Tensor) -> torch.Tensor:
    """(..., 18, 18) symmetric -> (..., 171) upper-triangle pack."""
    i, j = _triu18(h.device)
    return h[..., i, j]


def _sym_unpack(v: torch.Tensor) -> torch.Tensor:
    """(..., 171) -> full symmetric (..., 18, 18)."""
    out = torch.zeros(v.shape[:-1] + (18, 18), dtype=v.dtype,
                      device=v.device)
    i, j = _triu18(v.device)
    out[..., i, j] = v
    diag = out * torch.eye(18, dtype=v.dtype, device=v.device)
    return out + out.transpose(-1, -2) - diag


def cells_to_flat(vals: torch.Tensor, cells: CellTable, C: int) -> torch.Tensor:
    """(V, 18) cell-space values -> flat (C,) camera vector: a small row
    sum, on the card in the fixed order of the layout's ``flat`` map
    (:func:`cell_maps`)."""
    return sum_rows(vals.reshape(-1), cells.cols.reshape(-1), C,
                    cells.maps[0] if cells.maps else ())


def flat_to_cells(v: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Flat (C,) -> cell-space (V, 18) (tiny gather)."""
    return v[cols.long()]


def _row_pieces(Nb, W):
    step = max(1, _PIECE_SLOTS // W)
    for r0 in range(0, Nb, step):
        yield r0, min(Nb, r0 + step)


def _linearize_bucket_torch(pts_b, pf_b, b, packed, loss, loss_scale):
    """Torch chunk-path linearization of ONE bucket: each slot's table row
    is gathered by its global cell id (the reference selects it with an
    exact one-hot matmul). Returns (cost, BucketBlocks, g_p, hpp, g_cells
    (V, 18), h_cells (V, 171))."""
    Nb, W = b.cell.shape
    V = packed.shape[0]
    dtype, dev = pts_b.dtype, pts_b.device
    cost = torch.zeros((), dtype=dtype, device=dev)
    r = torch.empty((Nb, W, 2), dtype=dtype, device=dev)
    j_x = torch.empty((Nb, W, 2, 3), dtype=dtype, device=dev)
    j_cam = torch.empty((Nb, W, 2, 18), dtype=dtype, device=dev)
    g_p = torch.empty((Nb, 3), dtype=dtype, device=dev)
    hpp = torch.empty((Nb, 3, 3), dtype=dtype, device=dev)
    g_cells = torch.zeros((V, 18), dtype=dtype, device=dev)
    h_cells = torch.zeros((V, 171), dtype=dtype, device=dev)
    for k, (r0, r1) in enumerate(_row_pieces(Nb, W)):
        cell = b.cell[r0:r1].long()
        c = _unpack(packed[cell])
        cst, r_c, jx_c, jcam_c, gp_c, hpp_c = _linearize_chunk(
            pts_b[r0:r1], c, b.xy0[r0:r1], b.xy1[r0:r1], b.mask[r0:r1],
            pf_b[r0:r1], loss, loss_scale)
        cost = cost + cst
        r[r0:r1], j_x[r0:r1], j_cam[r0:r1] = r_c, jx_c, jcam_c
        g_p[r0:r1], hpp[r0:r1] = gp_c, hpp_c
        g18 = torch.einsum("bwkc,bwk->bwc", jcam_c, r_c).reshape(-1, 18)
        h18 = _sym_pack(torch.einsum("bwki,bwkj->bwij", jcam_c, jcam_c))
        pmap = b.pieces[k] if b.pieces else ()
        g_cells += sum_rows(g18, cell, V, pmap)
        h_cells += sum_rows(h18.reshape(-1, 171), cell, V, pmap)
    return (cost, BucketBlocks(r=r, j_x=j_x, j_cam=j_cam), g_p, hpp, g_cells,
            h_cells)


def _finish_system(cost, g_p_parts, hpp_parts, g_cells, hcc_packed, blocks,
                   points_t, cells, C):
    dtype, dev = points_t.dtype, points_t.device
    tail = points_t.shape[0] - sum(g.shape[0] for g in g_p_parts)
    if tail > 0:
        g_p_parts.append(torch.zeros((tail, 3), dtype=dtype, device=dev))
        hpp_parts.append(torch.zeros((tail, 3, 3), dtype=dtype, device=dev))
    hcc_cells = _sym_unpack(hcc_packed)
    return TileSystem(
        cost=cost, g_p=torch.cat(g_p_parts), hpp=torch.cat(hpp_parts),
        g_c=cells_to_flat(g_cells, cells, C), hcc_cells=hcc_cells,
        hcc_diag=cells_to_flat(
            torch.diagonal(hcc_cells, dim1=-2, dim2=-1), cells, C),
        blocks=tuple(blocks))


def linearize_tiles(points_t, packed, tiles: TileIndex, point_free_t, C: int,
                    loss: str = "trivial",
                    loss_scale: float = 0.5) -> TileSystem:
    """One full linearization over all buckets on the torch chunk path."""
    V = packed.shape[0]
    dtype, dev = points_t.dtype, points_t.device
    cost = torch.zeros((), dtype=dtype, device=dev)
    g_p_parts, hpp_parts, blocks = [], [], []
    g_cells = torch.zeros((V, 18), dtype=dtype, device=dev)
    hcc_packed = torch.zeros((V, 171), dtype=dtype, device=dev)
    offset = 0
    for b in tiles.buckets:
        Nb = b.cell.shape[0]
        cst, blk, gp_b, hpp_b, gc, hc = _linearize_bucket_torch(
            points_t[offset:offset + Nb], point_free_t[offset:offset + Nb], b,
            packed, loss, loss_scale)
        cost = cost + cst
        g_p_parts.append(gp_b)
        hpp_parts.append(hpp_b)
        blocks.append(blk)
        g_cells += gc
        hcc_packed += hc
        offset += Nb
    return _finish_system(cost, g_p_parts, hpp_parts, g_cells, hcc_packed,
                          blocks, points_t, tiles.cells, C)


def bucket_fused_ok(b: TileBucket) -> bool:
    """True when the bucket carries locality blocking narrow enough for the
    fused linearize kernel."""
    return bool(b.loc) and b.cell.shape[1] <= MAX_LIN_WIDTH


def linearize_tiles_mixed(points_t, packed, tiles: TileIndex, point_free_t,
                          C: int, loss: str = "trivial",
                          loss_scale: float = 0.5, plane_dtype=None):
    """Per-bucket fused-kernel / torch chunk-path linearization.

    Buckets with narrow locality blocking (:func:`bucket_fused_ok`) run
    ``tile_linearize_local`` and emit transposed sweep planes; the rest
    (wide or not locality-blocked) run the torch chunk path and keep
    :class:`BucketBlocks`. Returns ``(sys, planes)`` aligned per bucket:
    ``planes[i]`` = (local cell_t, jcam_t, jx_t, r_t) for fused buckets
    and None otherwise; ``sys.blocks[i]`` is None for fused buckets."""
    V = packed.shape[0]
    dtype, dev = points_t.dtype, points_t.device
    cost = torch.zeros((), dtype=dtype, device=dev)
    g_p_parts, hpp_parts, planes, blocks = [], [], [], []
    g_cells = torch.zeros((V, 18), dtype=dtype, device=dev)
    hcc_packed = torch.zeros((V, 171), dtype=dtype, device=dev)
    offset = 0
    for b in tiles.buckets:
        Nb, W = b.cell.shape
        pts_b = points_t[offset:offset + Nb]
        pf_b = point_free_t[offset:offset + Nb]
        if bucket_fused_ok(b):
            local, chunk_cells = b.loc
            tables = packed[chunk_cells.long()]       # (n_chunks, Vl, 78)
            pts_pack = torch.cat([pts_b.T, pf_b.T.to(dtype),
                                  torch.zeros((2, Nb), dtype=dtype,
                                              device=dev)]).contiguous()
            cell_t = local.T.contiguous()
            bins = b.bins or None
            cst, pout, r_t, jx_t, jcam_t, gc, hc = tile_linearize_local(
                pts_pack, cell_t, b.xy0.T.contiguous(), b.xy1.T.contiguous(),
                b.mask.T.contiguous(), tables.contiguous(), loss=loss,
                loss_scale=loss_scale, plane_dtype=plane_dtype, bins=bins)
            g_p_parts.append(pout[0:3].T)
            hpp_parts.append(pout[3:12].T.reshape(Nb, 3, 3))
            # each cell's chunk bins in one fixed order (no float atomics)
            g_cells += sum_chunk_bins(gc, chunk_cells, V, bins)
            hcc_packed += sum_chunk_bins(hc, chunk_cells, V, bins)
            planes.append((cell_t, jcam_t, jx_t, r_t))
            blocks.append(None)
        else:
            cst, blk, gp_b, hpp_b, gc, hc = _linearize_bucket_torch(
                pts_b, pf_b, b, packed, loss, loss_scale)
            g_p_parts.append(gp_b)
            hpp_parts.append(hpp_b)
            g_cells += gc
            hcc_packed += hc
            planes.append(None)
            blocks.append(blk)
        cost = cost + cst
        offset += Nb
    sys = _finish_system(cost, g_p_parts, hpp_parts, g_cells, hcc_packed,
                         blocks, points_t, tiles.cells, C)
    return sys, tuple(planes)


def _residual_planes(points_t, packed, tiles: TileIndex):
    """Per bucket, the (Nb, W, 2) masked residuals (torch ops)."""
    offset = 0
    for b in tiles.buckets:
        Nb, W = b.cell.shape
        r = torch.empty((Nb, W, 2), dtype=points_t.dtype,
                        device=points_t.device)
        for r0, r1 in _row_pieces(Nb, W):
            c = _unpack(packed[b.cell[r0:r1].long()])
            r[r0:r1] = _project_chunk(points_t[offset + r0:offset + r1], c,
                                      b.xy0[r0:r1], b.xy1[r0:r1],
                                      b.mask[r0:r1])["r"]
        yield b, r
        offset += Nb


def tile_cost(points_t, packed, tiles: TileIndex, loss: str = "trivial",
              loss_scale: float = 0.5) -> torch.Tensor:
    """Residual-only robustified cost (the trial-evaluation pass)."""
    total = torch.zeros((), dtype=points_t.dtype, device=points_t.device)
    for b, r in _residual_planes(points_t, packed, tiles):
        s = torch.sum(r * r, dim=-1)
        total = total + 0.5 * torch.sum(loss_rho(s, loss, loss_scale) * b.mask)
    return total


def tile_mse_planes(points_t, packed, tiles: TileIndex) -> tuple:
    """Per-slot MSE planes ((r0^2 + r1^2) / 2, one (Nb, W) per bucket): the
    re-evaluation pass of ``filterPoint3d`` (``src/DeepArcManager.cc:
    332-346``) in tile row space."""
    return tuple(0.5 * torch.sum(r * r, dim=-1)
                 for _, r in _residual_planes(points_t, packed, tiles))


def _e_sweep(tiles: TileIndex, sys: TileSystem, binv, v_cells,
             rhs_mode: bool) -> torch.Tensor:
    """One observation sweep over the torch blocks, binned to cell space
    (V, 18): E^T B^-1 g_p (rhs_mode) or E^T B^-1 E v."""
    V = sys.hcc_cells.shape[0]
    dtype, dev = sys.g_p.dtype, sys.g_p.device
    out = torch.zeros((V, 18), dtype=dtype, device=dev)
    offset = 0
    for b, blk in zip(tiles.buckets, sys.blocks):
        Nb, W = b.cell.shape
        for k, (r0, r1) in enumerate(_row_pieces(Nb, W)):
            cell = b.cell[r0:r1].long()
            j_x, j_cam = blk.j_x[r0:r1], blk.j_cam[r0:r1]
            binv_c = binv[offset + r0:offset + r1]
            if rhs_mode:
                w = torch.einsum("bij,bj->bi", binv_c,
                                 sys.g_p[offset + r0:offset + r1])
            else:
                t = torch.einsum("bwkc,bwc->bwk", j_cam, v_cells[cell])
                ev = torch.einsum("bwki,bwk->bi", j_x, t)
                w = torch.einsum("bij,bj->bi", binv_c, ev)
            t2 = torch.einsum("bwki,bi->bwk", j_x, w)
            u = torch.einsum("bwkc,bwk->bwc", j_cam, t2)
            out += sum_rows(u.reshape(-1, 18), cell, V,
                            b.pieces[k] if b.pieces else ())
        offset += Nb
    return out


def _e_dot_cells(tiles: TileIndex, sys: TileSystem,
                 v_cells) -> torch.Tensor:
    """(E v) per point row (Nrows, 3), for cell-space v (torch blocks)."""
    dtype, dev = sys.g_p.dtype, sys.g_p.device
    parts = []
    for b, blk in zip(tiles.buckets, sys.blocks):
        Nb, W = b.cell.shape
        ev = torch.empty((Nb, 3), dtype=dtype, device=dev)
        for r0, r1 in _row_pieces(Nb, W):
            t = torch.einsum("bwkc,bwc->bwk", blk.j_cam[r0:r1],
                             v_cells[b.cell[r0:r1].long()])
            ev[r0:r1] = torch.einsum("bwki,bwk->bi", blk.j_x[r0:r1], t)
        parts.append(ev)
    tail = sys.g_p.shape[0] - sum(p.shape[0] for p in parts)
    if tail > 0:
        parts.append(torch.zeros((tail, 3), dtype=dtype, device=dev))
    return torch.cat(parts)


# ---------------------------------------------------------------------------
# The LM step
# ---------------------------------------------------------------------------

# the tile step's implementations (the module's docstring)
TILE_IMPLS = KERNEL_IMPLS + ("xla",)


class TileState(NamedTuple):
    points: torch.Tensor   # (Nrows, 3) permuted+padded
    cam_vec: torch.Tensor  # (C,)
    cost: torch.Tensor
    tr: tr_mod.TRState
    k: int
    status: torch.Tensor


def _block_jacobi(sys: TileSystem, cells: CellTable, cam_aug, cam_free,
                  C: int):
    """6x6 block-Jacobi preconditioner assembled in cell space (the Ceres
    SCHUR_JACOBI analogue, camera-count independent)."""
    dtype, dev = sys.hcc_cells.dtype, sys.hcc_cells.device
    n_rows6 = C // 6
    diag = torch.cat([sys.hcc_cells[:, sl, sl] for sl in
                      (slice(0, 6), slice(6, 12), slice(12, 18))])
    blocks = sum_rows(diag, _block_rows(cells.cols), n_rows6,
                      cells.maps[1] if cells.maps else ())
    aug = cam_aug.reshape(n_rows6, 6)
    frozen = 1.0 - cam_free.reshape(n_rows6, 6)
    blocks = blocks + torch.eye(6, dtype=dtype, device=dev) * (
        aug + frozen)[:, :, None]
    # inv_ex: linalg.inv's result without its host-side error check
    inv_blocks = torch.linalg.inv_ex(blocks).inverse

    def precond(v):
        return torch.einsum("bij,bj->bi", inv_blocks,
                            v.reshape(n_rows6, 6)).reshape(-1)

    return precond


def _make_kernel_sweeps(tiles: TileIndex, sys: TileSystem, binv, lin_planes,
                        sweep_dtype, sweep_block_n: int):
    """Per-bucket sweep planes, once per step; returns (sweep, edot). A
    bucket of width <= MAX_KERNEL_WIDTH sweeps through ``tile_sweep_local``
    (with ``loc``, reading the chunk-sorted copy of its jcam planes,
    :func:`kernels.tile.sort_jcam_planes`, and summing its chunk bins into
    the cells with :func:`kernels.tile.sum_chunk_bins`) or ``tile_sweep``
    (without, reading the bucket's cell-sorted jcam copy,
    :func:`kernels.tile.sort_jcam`); a wider one through the torch
    sweeps. The copies are built here, once per step, on the card (the
    plain versions on the CPU do not read them)."""
    V = sys.hcc_cells.shape[0]
    dtype, dev = sys.g_p.dtype, sys.g_p.device
    planes = []
    offset = 0
    for i, b in enumerate(tiles.buckets):
        Nb, W = b.cell.shape
        binv_t = binv[offset:offset + Nb].reshape(Nb, 9).T.contiguous()
        gp_t = sys.g_p[offset:offset + Nb].T.contiguous()
        cc = b.loc[1].long() if b.loc else None
        if lin_planes[i] is not None:
            cell_t, jcam_t, jx_t = lin_planes[i][:3]
        elif W > MAX_KERNEL_WIDTH:
            planes.append(None)
            offset += Nb
            continue
        else:
            blk = sys.blocks[i]
            plane = b.loc[0] if b.loc else b.cell
            cell_t, jcam_t, jx_t = pack_bucket_planes(blk.j_x, blk.j_cam,
                                                      plane)
            if sweep_dtype is not None:
                jcam_t, jx_t = jcam_t.to(sweep_dtype), jx_t.to(sweep_dtype)
        srt = None
        if b.bins and jcam_t.is_cuda:
            srt = (sort_jcam_planes(jcam_t, b.bins, cc.shape[0])
                   if cc is not None else
                   sort_jcam(sys.blocks[i].j_cam, b.bins, jcam_t.dtype))
        planes.append((cell_t, jcam_t, jx_t, binv_t, gp_t, cc, srt))
        offset += Nb
    zeros_v = torch.zeros((V, 18), dtype=dtype, device=dev)

    def sub(i, off, Nb):
        b = tiles.buckets[i]
        sub_tiles = TileIndex(cells=tiles.cells, buckets=(b,),
                              row_of_point=tiles.row_of_point)
        sub_sys = sys._replace(g_p=sys.g_p[off:off + Nb],
                               blocks=(sys.blocks[i],))
        return sub_tiles, sub_sys

    def local_v(v_cells, cc):
        if v_cells is None:
            return torch.zeros((cc.shape[0], 18, cc.shape[1]), dtype=dtype,
                               device=dev)
        return v_cells[cc].transpose(1, 2).contiguous()

    def sweep(v_cells, rhs_mode):
        out = torch.zeros((V, 18), dtype=dtype, device=dev)
        mode = "rhs" if rhs_mode else "matvec"
        off = 0
        for i, b in enumerate(tiles.buckets):
            Nb = b.cell.shape[0]
            if planes[i] is None:
                sub_tiles, sub_sys = sub(i, off, Nb)
                out += _e_sweep(sub_tiles, sub_sys, binv[off:off + Nb],
                                v_cells, rhs_mode)
            else:
                cell_t, jcam_t, jx_t, binv_t, gp_t, cc, srt = planes[i]
                bins = b.bins or None
                if cc is not None:
                    part = tile_sweep_local(
                        cell_t, jcam_t, jx_t, binv_t, gp_t,
                        local_v(None if rhs_mode else v_cells, cc),
                        mode=mode, block_n=sweep_block_n, bins=bins,
                        sorted_jcam=srt)
                    out += sum_chunk_bins(part, cc, V, bins)
                else:
                    out += tile_sweep(
                        cell_t, jcam_t, jx_t, binv_t, gp_t,
                        zeros_v if rhs_mode else v_cells, mode=mode,
                        block_n=sweep_block_n, bins=bins, sorted_jcam=srt)
            off += Nb
        return out

    def edot(v_cells):
        parts = []
        off = 0
        for i, b in enumerate(tiles.buckets):
            Nb = b.cell.shape[0]
            if planes[i] is None:
                sub_tiles, sub_sys = sub(i, off, Nb)
                parts.append(_e_dot_cells(sub_tiles, sub_sys, v_cells)[:Nb])
            else:
                cell_t, jcam_t, jx_t, binv_t, gp_t, cc, _ = planes[i]
                if cc is not None:
                    parts.append(tile_sweep_local(
                        cell_t, jcam_t, jx_t, binv_t, gp_t,
                        local_v(v_cells, cc), mode="edot",
                        block_n=sweep_block_n))
                else:
                    parts.append(tile_sweep(
                        cell_t, jcam_t, jx_t, binv_t, gp_t, v_cells,
                        mode="edot", block_n=sweep_block_n))
            off += Nb
        tail = sys.g_p.shape[0] - off
        if tail > 0:
            parts.append(torch.zeros((tail, 3), dtype=dtype, device=dev))
        return torch.cat(parts)

    return sweep, edot


def _params_from(cam_vec, points, template: BAParams) -> BAParams:
    return dataclasses.replace(unflatten_camera(cam_vec, template),
                               points=points)


def make_tile_step(options: SolverOptions, template: BAParams,
                   impl: str = "auto", sweep_dtype=None,
                   sweep_block_n: int = 256, reducer=None,
                   device_loop: bool = False):
    """LM step over the tile layout:
    step(state, tiles, cam_free, point_free_t) -> (state, info).

    ``impl`` picks the linearize and the sweeps (the module's docstring).

    With ``reducer`` (``parallel.multihost.Reducer``), the step is one
    shard of a sharded step: each rank holds its rows of every bucket, and
    the cell-space sums (gradient, Grams, the PCG's rhs and correction
    bins) and the trust-region scalars go through the reducer. Without it:
    the single-device step.

    ``sweep_dtype`` (e.g. ``torch.bfloat16``) stores the per-slot Jacobian
    planes that the PCG sweeps re-read every iteration in that dtype; every
    sum, the LM system (gc/hcc, costs, trust region) and the accept test
    stay in the working dtype (the kernel path only). ``sweep_block_n`` is
    the sweep kernels' threads per block. ``device_loop=True`` (the
    ``while_loop`` driver) runs PCG as :func:`solver.linalg.pcg_device`,
    whose iteration count ``info.cg_iters`` stays a device tensor."""
    if impl == "dual":
        raise ValueError(
            "impl='dual' (the reference's camera-major sweeps) is not "
            "ported: on the H100 it lost to the kernel sweeps (PERF.md); "
            "use impl='pallas'")
    if impl not in TILE_IMPLS:
        raise ValueError(f"unknown tile impl {impl!r}; one of {TILE_IMPLS}")
    kernels = impl in KERNEL_IMPLS
    C = 6 * template.ext_rot.shape[0] + 6 * template.center.shape[0]
    allsum, allmax, allsum_sym = reductions(reducer)

    def step(state: TileState, tiles: TileIndex, cam_free, point_free_t):
        cells, cols = tiles.cells, tiles.cells.cols
        dev = state.points.device
        with span("deeparc.tiles.linearize", device=True):
            params = _params_from(state.cam_vec, state.points, template)
            packed = pack_cells(slot_params(params, tiles.cells),
                                tiles.cells, cam_free)
            if kernels:
                sys, lin_planes = linearize_tiles_mixed(
                    state.points, packed, tiles, point_free_t, C,
                    options.loss, options.loss_scale, plane_dtype=sweep_dtype)
            else:
                sys = linearize_tiles(state.points, packed, tiles,
                                      point_free_t, C, options.loss,
                                      options.loss_scale)
            if reducer is not None:
                # the Grams move packed; the flat diagonal is re-derived
                # from the summed Grams, not summed on its own
                hcc_cells = allsum_sym(sys.hcc_cells)
                sys = sys._replace(
                    g_c=allsum(sys.g_c), hcc_cells=hcc_cells,
                    hcc_diag=cells_to_flat(
                        torch.diagonal(hcc_cells, dim1=-2, dim2=-1), cells,
                        C))

        # augmented per-point blocks
        binv = augmented_point_blocks(sys.hpp, point_free_t, state.tr.radius,
                                      options)
        d2c = tr_mod.lm_diagonal(sys.hcc_diag, options.min_lm_diagonal,
                                 options.max_lm_diagonal)
        cam_aug = d2c / state.tr.radius

        if kernels:
            sweep_fn, edot_fn = _make_kernel_sweeps(
                tiles, sys, binv, lin_planes, sweep_dtype, sweep_block_n)
        else:
            sweep_fn = lambda v_cells, rhs_mode: _e_sweep(
                tiles, sys, binv, v_cells, rhs_mode)
            edot_fn = lambda v_cells: _e_dot_cells(tiles, sys, v_cells)
        rhs = (-sys.g_c
               + cells_to_flat(allsum(sweep_fn(None, True)), cells, C)) \
            * cam_free

        def hcc_matvec(v):
            out = torch.einsum("vij,vj->vi", sys.hcc_cells,
                               flat_to_cells(v, cols))
            return cells_to_flat(out, cells, C)

        def matvec(v):
            vm = v * cam_free
            corr = cells_to_flat(
                allsum(sweep_fn(flat_to_cells(vm, cols), False)), cells, C)
            s = hcc_matvec(vm) + cam_aug * v - corr
            return torch.where(cam_free > 0.5, s, v)

        precond = _block_jacobi(sys, tiles.cells, cam_aug, cam_free, C)
        with span("deeparc.tiles.pcg", device=True) as sp:
            result = (pcg_device if device_loop else pcg)(
                matvec, rhs, precond=precond,
                max_iterations=options.cg_max_iterations,
                tol=options.cg_tolerance)
            if not device_loop:     # pcg_device's count stays on the card
                sp.set(iterations=result.iterations)
        dc = result.x * cam_free
        e_dc = edot_fn(flat_to_cells(dc, cols))
        dp = -torch.einsum("bij,bj->bi", binv, sys.g_p + e_dc) * point_free_t

        # model cost change from the quadratic pieces
        dtg = allsum(torch.sum(dp * sys.g_p)) + torch.dot(dc, sys.g_c)
        dhd = (allsum(torch.einsum("bi,bij,bj->", dp, sys.hpp, dp)
                      + 2.0 * torch.sum(dp * e_dc))
               + torch.dot(dc, hcc_matvec(dc)))
        mcc = -(dtg + 0.5 * dhd)

        new_points = state.points + dp
        new_cam = state.cam_vec + dc
        with span("deeparc.tiles.trial_cost", device=True):
            trial = _params_from(new_cam, new_points, template)
            trial_packed = pack_cells(slot_params(trial, tiles.cells),
                                      tiles.cells, cam_free)
            new_cost = allsum(tile_cost(new_points, trial_packed, tiles,
                                        options.loss, options.loss_scale))

        rho = (state.cost - new_cost) / torch.clamp(mcc, min=1e-300)
        accept = (mcc > 0) & (rho > options.min_relative_decrease)
        tr_next = tr_mod.select(
            accept, tr_mod.step_accepted(state.tr, rho, options.max_radius),
            tr_mod.step_rejected(state.tr))
        grad_max = torch.maximum(torch.max(torch.abs(sys.g_c)),
                                 allmax(torch.max(torch.abs(sys.g_p))))
        step_norm = torch.sqrt(allsum(torch.sum(dp * dp))
                               + torch.dot(dc, dc))
        x_norm = torch.sqrt(allsum(torch.sum(state.points * state.points))
                            + torch.dot(state.cam_vec, state.cam_vec))
        cost_change = state.cost - new_cost
        ftol = accept & (torch.abs(cost_change)
                         <= options.function_tolerance * state.cost)
        ptol = accept & (step_norm <= options.parameter_tolerance
                         * (x_norm + options.parameter_tolerance))
        gtol = grad_max <= options.gradient_tolerance
        radius_min = tr_next.radius <= options.min_radius
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        status = torch.where(gtol, 3, torch.where(ftol, 2, torch.where(
            ptol, 4, torch.where(radius_min, 5, zero))))
        info = StepInfo(cost=torch.where(accept, new_cost, state.cost),
                        cost_change=cost_change, grad_max=grad_max,
                        step_norm=step_norm, radius=state.tr.radius, rho=rho,
                        accepted=accept, cg_iters=result.iterations)
        next_state = TileState(
            points=torch.where(accept, new_points, state.points),
            cam_vec=torch.where(accept, new_cam, state.cam_vec),
            cost=info.cost, tr=tr_next, k=state.k + 1, status=status)
        return next_state, info

    return step


def init_tile_state(params_t: BAParams, tiles: TileIndex,
                    options: SolverOptions, cam_free=None,
                    reducer=None) -> TileState:
    """The start state; with ``reducer`` its cost is summed over the ranks'
    rows, as in the step."""
    dtype, dev = params_t.points.dtype, params_t.points.device
    if cam_free is None:
        cam_free = torch.ones(6 * params_t.ext_rot.shape[0]
                              + 6 * params_t.center.shape[0], dtype=dtype,
                              device=dev)
    packed = pack_cells(slot_params(params_t, tiles.cells), tiles.cells,
                        cam_free)
    cost0 = tile_cost(params_t.points, packed, tiles, options.loss,
                      options.loss_scale)
    if reducer is not None:
        cost0 = reducer.sum(cost0)
    return TileState(points=params_t.points, cam_vec=flatten_camera(params_t),
                     cost=cost0,
                     tr=tr_mod.init_tr(options.initial_radius, dtype, dev),
                     k=0, status=torch.zeros((), dtype=torch.int64,
                                             device=dev))


def solve_ba_tiles(scene: Scene, free: BAParams,
                   options: SolverOptions = SolverOptions(),
                   chunk_obs: int = CHUNK_OBS, min_width: int = 4,
                   checkpoint_path: str | None = None,
                   checkpoint_every: int = 10, resume: bool = False,
                   logger=None, locality: bool = True,
                   driver: str = "python",
                   while_block: int = 10, impl: str = "auto") -> BAResult:
    """LM to convergence on the tile engine, from a Scene; points come back
    in original order. ``locality=False`` keeps every bucket on the global
    cell table (the ``tile_sweep`` kernel path). The impl, checkpoint,
    logger and driver arguments are :func:`solve_tiles_prepared`'s."""
    tiles, params_t, free_t = tiles_from_scene(
        scene, free, min_width=min_width, chunk_obs=chunk_obs,
        locality=locality)
    return solve_tiles_prepared(
        params_t, tiles, free_t, flatten_camera(free), options, impl=impl,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
        resume=resume, logger=logger, driver=driver, while_block=while_block)


@traced("deeparc.solve")
def solve_tiles_prepared(params_t: BAParams, tiles: TileIndex, free_t,
                         cam_free, options: SolverOptions = SolverOptions(),
                         impl: str = "auto", sweep_dtype=None,
                         checkpoint_path: str | None = None,
                         checkpoint_every: int = 10, resume: bool = False,
                         logger=None,
                         unpermute: bool = True,
                         driver: str = "python",
                         while_block: int = 10,
                         _cache: dict | None = None) -> BAResult:
    """LM to convergence on a PREPARED tile layout (row-space inputs),
    through ``impl``'s linearize and sweeps (:func:`make_tile_step`).

    ``driver="python"``: one Python-driven step per iteration with
    Ceres-style progress lines, the wall-clock cap (``src/sfm.cc:71``), a
    solver-state checkpoint every ``checkpoint_every`` iterations in
    ORIGINAL point order (``resume=True`` maps it back into row space and
    restarts from its trust-region state) and a ``JsonlLogger``.
    ``driver="while_loop"``: blocks of up to ``while_block`` steps, PCG
    included, with no host read inside a block (on the card one CUDA
    graph, ``solver/device_loop.py``); the host applies the wall-clock
    cap and writes the checkpoint (when ``checkpoint_path`` is given)
    between blocks, and prints and logs nothing per iteration.

    The pipeline's solve/filter loop calls this once per round with
    updated mask planes / freeze rows on the same layout; passing the same
    ``_cache`` dict across rounds reuses the step, and under the
    ``while_loop`` driver the captured block (``_cache["block"]``, which
    keeps copies of the layout and freeze masks that each call refreshes);
    a call with another ``impl`` empties it first.
    ``unpermute=False`` returns points in row space."""
    if driver not in ("python", "while_loop"):
        raise ValueError(f"unknown driver {driver!r}")
    cache = _cache if _cache is not None else {}
    if cache.get("impl", impl) != impl:
        cache.clear()
    cache["impl"] = impl
    make = functools.partial(make_tile_step, options, params_t, impl,
                             sweep_dtype)
    with span("deeparc.tiles.step_build"):
        if "step" not in cache:
            cache["step"] = make()
        step = cache["step"]
    with span("deeparc.tiles.init"):
        state = init_tile_state(params_t, tiles, options, cam_free)
        ck = load_checkpoint(checkpoint_path, resume, params_t)
        if ck is not None:
            # checkpoints hold points in original order; pad and dead rows
            # keep the values tiles_from_scene gave them (their mask is 0)
            ck_params, scal = ck
            points = params_t.points.clone()
            points[tiles.row_of_point.long()] = ck_params.points
            state = init_tile_state(
                dataclasses.replace(ck_params, points=points), tiles,
                options, cam_free)._replace(tr=tr_of(scal, params_t.points),
                                            k=scal["iteration"])

    def original(st):
        out = unflatten_camera(st.cam_vec, params_t)
        return dataclasses.replace(
            out, points=unpermute_points(st.points, tiles))

    if driver == "while_loop":
        from deeparc_tpu_torch.solver.device_loop import (
            BlockLoop,
            solve_blocks,
        )

        inputs = (tiles, cam_free, free_t)
        loop = cache.get("block")
        if loop is None:
            loop = BlockLoop(make(device_loop=True), inputs,
                             own_inputs=_cache is not None)
            if _cache is not None:
                cache["block"] = loop
        else:
            loop.set_inputs(inputs)
        res = solve_blocks(loop, state, options, while_block,
                           checkpoint_path, original, engine="tiles")
        if not unpermute:
            pts = loop.state.points.clone()
            res = res._replace(params=dataclasses.replace(res.params,
                                                          points=pts))
        return res
    step = debug.checked_step(step, "tiles")
    t0 = time.time()
    k, cg_total = state.k, 0
    if options.progress_to_stdout:
        print_header(k, state.cost, cg=True)
    with span(LM_LOOP):
        while lm_running(state.status) and k < options.max_iterations:
            if time.time() - t0 > options.max_seconds:
                break
            with span("deeparc.lm.step"):
                state, info = step(state, tiles, cam_free, free_t)
            k += 1
            if options.progress_to_stdout:
                print_iteration(k, info, cg=True)
            log_iteration(logger, k, info)
            if checkpoint_path and k % checkpoint_every == 0:
                save_checkpoint(checkpoint_path, original(state), state.tr, k,
                                state.cost)
            cg_total += info.cg_iters
    out = unflatten_camera(state.cam_vec, params_t)
    pts = unpermute_points(state.points, tiles) if unpermute else state.points
    return BAResult(params=dataclasses.replace(out, points=pts),
                    cost=float(state.cost), iterations=k,
                    status=int(state.status), seconds=time.time() - t0,
                    cg_iterations=cg_total)

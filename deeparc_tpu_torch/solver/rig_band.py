"""Live-band preparation for the grid engine, PyTorch port of
``deeparc_tpu.solver.rig_band``.

A surface point on a turntable rig is seen from a contiguous CYCLIC window
of rotation positions, so after renumbering cells and sorting points by
the circular mean of their visible cells, each kernel tile of ``block_np``
points touches a narrow band of cells. The prep:

1. tries several cell orderings (identity, reverse Cuthill-McKee, a
   spectral cyclic embedding) and keeps the one with the least paid slot
   work;
2. sorts points by the circular mean angle of their visible cells;
3. per point tile, finds the minimal cyclic window of 8-cell slabs that
   covers every live cell, buckets tiles into width groups, and gathers
   each group's band planes.

The co-visibility Gram, the point order and the tile liveness run on the
grid's device; only (T, T)- and (n_tiles, nb)-sized summaries cross to the
host. When no ordering yields bands narrower than ``max_frac * t_pad``
(dense or uniform-random visibility) the prep returns None and the solve
uses the monolithic kernels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from deeparc_tpu_torch.solver.rig_grid import GridIndex


class BandPrep(NamedTuple):
    grid: GridIndex      # cell-renumbered, point-sorted; band tables attached
    w_band: int          # max band width (cells) over lin groups
    w_band_cost: int     # max band width over cost groups
    perm: torch.Tensor   # (N,) sorted row i holds original point perm[i]
    inv: torch.Tensor    # (N,) original point p sits at sorted row inv[p]
    block_np: int = 256
    cost_block_np: int = 1024
    lin_groups: tuple = ()    # ((w, tile_lo, tile_hi), ...)
    cost_groups: tuple = ()
    cell_perm: torch.Tensor | None = None   # new cell rank -> old cell id

    @property
    def widths(self):
        """(band_widths, band_blocks) for make_grid_step/init_grid_state."""
        return ((self.lin_groups or self.w_band,
                 self.cost_groups or self.w_band_cost),
                (self.block_np, self.cost_block_np))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _partition_widths(covers8: np.ndarray, max_groups: int):
    """Optimal contiguous partition of SORTED tile covers into <= max_groups
    width buckets minimizing sum(n_g * max_g). Returns the bucket width (in
    8-cell slabs, >= 1) per tile, in unsorted order."""
    n = covers8.shape[0]
    order = np.argsort(covers8, kind="stable")
    c = np.maximum(covers8[order].astype(np.float64), 1.0)
    dp_prev = (n - np.arange(n + 1)) * c[-1]
    dp_prev[n] = 0.0
    cuts = [None]
    for _ in range(2, max_groups + 1):
        dp = np.zeros(n + 1)
        cut = np.full(n + 1, n, np.int64)
        for i in range(n - 1, -1, -1):
            v = np.arange(1, n - i + 1) * c[i:] + dp_prev[i + 1:]
            j = int(np.argmin(v))
            dp[i] = v[j]
            cut[i] = i + 1 + j
        dp_prev, _ = dp, cuts.append(cut)
    widths_sorted = np.empty(n, np.int64)
    g, i = len(cuts) - 1, 0
    while i < n:
        j = int(cuts[g][i]) if g >= 1 and cuts[g] is not None else n
        widths_sorted[i:j] = int(c[j - 1])
        i, g = j, max(g - 1, 0)
    out = np.empty(n, np.int64)
    out[order] = widths_sorted
    return out


def _cell_orderings(cooc: np.ndarray, names) -> list:
    """Candidate cell permutations (each maps new rank -> old cell id)."""
    T = cooc.shape[0]
    out = []
    if "identity" in names:
        out.append(np.arange(T, dtype=np.int64))
    if "rcm" in names and T > 2:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        adj = sp.csr_matrix((cooc > 0).astype(np.float32))
        out.append(np.asarray(
            reverse_cuthill_mckee(adj, symmetric_mode=True), np.int64))
    if "spectral" in names and T > 3:
        # the two leading nontrivial eigenvectors of the degree-normalized
        # co-visibility operator trace out the circle for cyclically banded
        # graphs; their angle recovers the ring order
        a = cooc.astype(np.float64)
        d = np.maximum(a.sum(axis=1), 1e-9)
        a = a / np.sqrt(d[:, None] * d[None, :])
        _, vecs = np.linalg.eigh(a)
        out.append(np.argsort(np.arctan2(vecs[:, -3], vecs[:, -2]))
                   .astype(np.int64))
    return out


def point_angles(mask, cell_perm):
    """Circular-mean angle of each point's visible cells under
    ``cell_perm``. Two points whose means agree in exact arithmetic may
    differ in the last bits here, by the summation order of the matmul."""
    T = mask.shape[1]
    m = mask[:, cell_perm]
    ang = 2.0 * np.pi * torch.arange(T, dtype=mask.dtype,
                                     device=mask.device) / T
    return torch.atan2(m @ torch.sin(ang), m @ torch.cos(ang))


def _point_order(mask, cell_perm):
    """Circular-mean cell angle per point -> stable sorted point order."""
    return torch.argsort(point_angles(mask, cell_perm), stable=True)


def _tile_liveness(mask, order, cell_perm, t_pad, bn, n_pad):
    """(n_tiles, t_pad/8) slab liveness of the sorted + permuted mask."""
    N, T = mask.shape
    m = torch.zeros((n_pad, t_pad), dtype=mask.dtype, device=mask.device)
    m[:N, :T] = mask[order][:, cell_perm]
    return m.reshape(n_pad // bn, bn, t_pad // 8, 8).sum(dim=(1, 3)) > 0.5


def _covers_from_liveness(lv: np.ndarray):
    """Per-tile minimal cyclic 8-block window -> (starts8, covers8)."""
    n_tiles, nb = lv.shape
    starts = np.zeros(n_tiles, np.int32)
    covers = np.ones(n_tiles, np.int32)
    for i, row in enumerate(lv):
        pos = np.nonzero(row)[0]
        if pos.size == 0:
            covers[i] = 0
            continue
        gaps = np.diff(np.concatenate([pos, [pos[0] + nb]]))
        gmax = int(np.argmax(gaps))
        starts[i] = pos[(gmax + 1) % pos.size]
        covers[i] = nb - int(gaps[gmax]) + 1
    return starts, covers


def _partition_sequence(covers8: np.ndarray, max_groups: int, t_pad: int):
    """Contiguous partition (no reorder) of tile covers into <= max_groups
    segments minimizing sum(len_g * max_g). Returns ((w_cells, lo, hi), ...)."""
    n = covers8.shape[0]
    if n == 0:
        return ((8, 0, 0),)
    c = np.minimum(np.maximum(covers8.astype(np.int64), 1), t_pad // 8)
    INF = float("inf")
    dp_prev = np.full(n + 1, INF)
    dp_prev[n] = 0.0
    run = np.maximum.accumulate(c[::-1])[::-1]
    for i in range(n):
        dp_prev[i] = (n - i) * run[i]
    cuts = [None]
    for _ in range(2, max_groups + 1):
        dp = np.full(n + 1, INF)
        dp[n] = 0.0
        cut = np.full(n + 1, n, np.int64)
        for i in range(n - 1, -1, -1):
            m, best, bj = 0, INF, n
            for j in range(i + 1, n + 1):
                if c[j - 1] > m:
                    m = c[j - 1]
                v = (j - i) * m + dp_prev[j]
                if v < best:
                    best, bj = v, j
            dp[i] = best
            cut[i] = bj
        dp_prev, _ = dp, cuts.append(cut)
    groups = []
    g, i = len(cuts) - 1, 0
    while i < n:
        j = int(cuts[g][i]) if g >= 1 and cuts[g] is not None else n
        groups.append((int(c[i:j].max()) * 8, i, j))
        i, g = j, max(g - 1, 0)
    return tuple(groups)


def _group_tiles(covers8, max_groups):
    """Bucket tiles by cover width; tiles keep their angular order inside
    each bucket. Returns (tile_order, ((w_cells, lo, hi), ...))."""
    if covers8.size == 0:
        return np.zeros((0,), np.int64), ()
    buckets = _partition_widths(covers8, max_groups)
    tile_order = np.argsort(buckets, kind="stable")
    b_sorted = buckets[tile_order]
    groups, lo = [], 0
    for w in np.unique(b_sorted):
        hi = int(np.searchsorted(b_sorted, w, side="right"))
        groups.append((int(w) * 8, lo, hi))
        lo = hi
    return tile_order, tuple(groups)


def _gather_stacks(grid, starts_d, starts_cost_d, lin_groups, cost_groups,
                   block_np, cost_block_np, w_max):
    """The plane stacks of both tilings, after the start tables are checked
    against the cell table (``kernels.rig_grid.check_band_starts``): the
    one place the tables a solve's kernels index with are checked."""
    from deeparc_tpu_torch.kernels.rig_grid import (
        banded_planes,
        check_band_starts,
        gather_banded_planes,
    )

    t_pad = _round_up(grid.xy0.shape[1], 8)
    check_band_starts(starts_d, t_pad)
    check_band_starts(starts_cost_d, t_pad)
    N = grid.xy0.shape[0]
    n_pad = _round_up(N, max(block_np, cost_block_np))
    pxm_ext = banded_planes(grid, n_pad, w_max)
    pxm_lin = tuple(gather_banded_planes(pxm_ext, starts_d, w, block_np,
                                         lo, hi) for w, lo, hi in lin_groups)
    pxm_cost = tuple(gather_banded_planes(pxm_ext, starts_cost_d, w,
                                          cost_block_np, lo, hi)
                     for w, lo, hi in cost_groups)
    return pxm_lin, pxm_cost


def _permuted(grid: GridIndex, order, cell_perm) -> GridIndex:
    """The grid with points in ``order`` and cells in ``cell_perm``."""
    rows = lambda t: t[order][:, cell_perm]
    return dataclasses.replace(
        grid, xy0=rows(grid.xy0), xy1=rows(grid.xy1), mask=rows(grid.mask),
        point_mask=grid.point_mask[order],
        slot_outer=grid.slot_outer[cell_perm],
        slot_inner=grid.slot_inner[cell_perm],
        slot_intr=grid.slot_intr[cell_perm],
        onehot_outer=grid.onehot_outer[cell_perm],
        onehot_inner=grid.onehot_inner[cell_perm],
        onehot_intr=grid.onehot_intr[cell_perm],
        focal_shared=grid.focal_shared[cell_perm],
        dist_m1=grid.dist_m1[cell_perm], dist_m2=grid.dist_m2[cell_perm],
        band=())


def band_grid(grid: GridIndex, block_np: int = 256, cost_block_np: int = 1024,
              max_frac: float = 0.85,
              orderings=("identity", "rcm", "spectral"), max_groups: int = 4,
              max_groups_cost: int = 3) -> BandPrep | None:
    """Build the banded layout, or None when banding would not pay.

    The caller permutes point-indexed arrays by ``prep.perm`` before
    solving and maps results back with ``prep.inv``; cell renumbering is
    internal to the returned grid."""
    N, T = grid.xy0.shape
    t_pad = _round_up(T, 8)
    if T < 16:
        return None
    if max(block_np, cost_block_np) % min(block_np, cost_block_np):
        raise ValueError("one point-tile width must divide the other: the "
                         "two tilings share one padded point count")
    dev = grid.mask.device
    n_pad = _round_up(N, max(block_np, cost_block_np))
    cooc = (grid.mask.T @ grid.mask).cpu().numpy()         # (T, T)
    n_live = -(-N // block_np)

    best = None
    for cell_perm in _cell_orderings(cooc, orderings):
        cp = torch.as_tensor(cell_perm, device=dev)
        order = _point_order(grid.mask, cp)
        lv = _tile_liveness(grid.mask, order, cp, t_pad, block_np,
                            n_pad).cpu().numpy()
        starts, covers = _covers_from_liveness(lv)
        # selection metric: the PAID slot work after width bucketing, over
        # tiles that hold real points
        work = int(_partition_widths(covers[:n_live], max_groups).sum())
        if best is None or work < best[0]:
            best = (work, cp, order, starts, covers)
    work, cell_perm, order, starts, covers = best
    n_tiles = n_pad // block_np
    if work * 8 >= max_frac * t_pad * n_live:
        return None

    # width-bucketed tile reorder; tiles overlapping the padding stay last
    n_full = N // block_np
    tile_order_full, lin_groups = _group_tiles(covers[:n_full], max_groups)
    tile_order = np.concatenate([tile_order_full,
                                 np.arange(n_full, n_tiles)])
    if n_full < n_tiles:
        w_tail = max(int(covers[n_full:].max()), 1) * 8
        lin_groups = lin_groups + ((w_tail, n_full, n_tiles),)
    starts = starts[tile_order]
    order_np = order.cpu().numpy()
    full_rows = order_np[: n_full * block_np].reshape(n_full, block_np)
    order = torch.as_tensor(np.concatenate(
        [full_rows[tile_order_full].reshape(-1),
         order_np[n_full * block_np:]]), device=dev)
    w_band = max(w for w, _, _ in lin_groups)

    # cost tiling on the FINAL point order: a contiguous sequence partition
    lv_cost = _tile_liveness(grid.mask, order, cell_perm, t_pad,
                             cost_block_np, n_pad).cpu().numpy()
    starts_cost, covers_cost = _covers_from_liveness(lv_cost)
    cost_groups = _partition_sequence(covers_cost, max_groups_cost, t_pad)
    w_cost = max(w for w, _, _ in cost_groups)

    new_grid = _permuted(grid, order, cell_perm)
    starts_d = torch.as_tensor(starts, dtype=torch.int32, device=dev)
    starts_cost_d = torch.as_tensor(starts_cost, dtype=torch.int32,
                                    device=dev)
    pxm_lin, pxm_cost = _gather_stacks(
        new_grid, starts_d, starts_cost_d, lin_groups, cost_groups, block_np,
        cost_block_np, max(w_band, w_cost))
    new_grid = dataclasses.replace(
        new_grid, band=(starts_d, starts_cost_d, pxm_lin, pxm_cost))
    return BandPrep(grid=new_grid, w_band=int(w_band), w_band_cost=int(w_cost),
                    perm=order, inv=torch.argsort(order), block_np=block_np,
                    cost_block_np=cost_block_np, lin_groups=lin_groups,
                    cost_groups=cost_groups, cell_perm=cell_perm)


def band_grid_update(prep: BandPrep, grid: GridIndex) -> BandPrep:
    """Refresh a BandPrep for an UPDATED mask of the same scene.

    The pipeline's filter rounds only REMOVE observations, so the stored
    covers stay valid and orderings, widths, groups and start tables are
    reused; only the band planes are gathered again. The update refuses a
    mask with any live observation that was dead in the prep's mask: the
    banded kernels would skip it wherever it lies outside the stored
    bands."""
    order, cp = prep.perm, prep.cell_perm
    mask = grid.mask[order][:, cp]
    moved = int(torch.count_nonzero((mask != 0) & (prep.grid.mask == 0)))
    if moved:
        raise ValueError(
            f"band_grid_update: {moved} live observations were dead at prep "
            f"time; the stored band covers are only valid for masks that "
            f"remove observations — run band_grid")
    g = dataclasses.replace(
        prep.grid, xy0=grid.xy0[order][:, cp], xy1=grid.xy1[order][:, cp],
        mask=mask, point_mask=grid.point_mask[order], band=())
    starts_d, starts_cost_d = prep.grid.band[0], prep.grid.band[1]
    pxm_lin, pxm_cost = _gather_stacks(
        g, starts_d, starts_cost_d, prep.lin_groups, prep.cost_groups,
        prep.block_np, prep.cost_block_np, max(prep.w_band, prep.w_band_cost))
    g = dataclasses.replace(g, band=(starts_d, starts_cost_d, pxm_lin,
                                     pxm_cost))
    return prep._replace(grid=g)

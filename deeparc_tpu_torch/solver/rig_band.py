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

Everything but the cell orderings runs on the grid's device as array
programs: the point order, the tile liveness, each tile's cover, and the
width partitions (dynamic programs over whole cost matrices, with no loop
over tiles or cut points). What crosses to the host: the (T, T)
co-visibility Gram, which the orderings are computed from; one ``work``
scalar per candidate ordering; and at the end the width groups of both
tilings, a few integers each. When no ordering yields bands narrower than
``max_frac * t_pad`` (dense or uniform-random visibility) the prep returns
None and the solve uses the monolithic kernels.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from deeparc_tpu_torch.solver.rig_grid import GridIndex
from deeparc_tpu_torch.utils.profiling import span


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


def _cut_ends(pay, dp, max_groups: int):
    """Optimal contiguous cuts of n items into <= max_groups segments, on
    the device.

    ``pay[i, e - 1]`` is what segment [i, e) pays (inf where e <= i), the
    same at every level; ``dp[i]`` what [i, n) pays as one segment
    (``dp[n]`` = 0). Level by level, the cut at i is the FIRST e that
    minimises ``pay[i, e - 1] + dp_prev[e]``, as the reference's loops
    keep it. Returns the (max_groups,) segment ends from item 0, the last
    n (a segment after an end of n is empty)."""
    n = pay.shape[0]
    col = torch.arange(n, device=pay.device)
    cuts = []
    for _ in range(2, max_groups + 1):
        v = pay + dp[1:]
        best = v.min(dim=1).values
        first = torch.where(v == best[:, None], col, n).min(dim=1).values
        dp = torch.cat([best, best.new_zeros(1)])
        cuts.append(torch.cat([first + 1, first.new_full((1,), n)]))
    # walk the cuts from item 0 with 1-element index tensors: no host read
    i = torch.zeros(1, dtype=torch.long, device=pay.device)
    ends = []
    for cut in reversed(cuts):
        i = cut[i]
        ends.append(i)
    ends.append(torch.full((1,), n, dtype=torch.long, device=pay.device))
    return torch.cat(ends)


def _partition_widths(covers8: torch.Tensor, max_groups: int):
    """Optimal contiguous partition of SORTED tile covers into <= max_groups
    width buckets minimizing sum(n_g * max_g). Returns the bucket width (in
    8-cell slabs, >= 1) per tile, in unsorted order, on the covers'
    device. Every sum is of small integers in float64, so exact."""
    n = covers8.shape[0]
    order = torch.argsort(covers8, stable=True)
    c = covers8[order].double().clamp(min=1.0)
    k = torch.arange(n + 1, device=covers8.device)
    dp = (n - k).double() * c[-1]
    dp[n] = 0.0
    seg_len = k[1:] - k[:-1, None]                 # [i, e - 1] -> e - i
    pay = torch.where(seg_len > 0, seg_len.double() * c, torch.inf)
    ends = _cut_ends(pay, dp, max_groups)
    seg = torch.searchsorted(ends, k[:-1], right=True)
    out = torch.empty(n, dtype=torch.long, device=covers8.device)
    out[order] = c[ends[seg] - 1].long()
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


def _slab_counts(mask, cell_perm, t_pad):
    """(N, t_pad/8): each point's mask summed over each 8-cell slab of the
    cell order ``cell_perm`` (a 0/1 mask: exact counts)."""
    T = mask.shape[1]
    rank = torch.empty_like(cell_perm)
    rank[cell_perm] = torch.arange(T, device=mask.device)
    onehot = torch.zeros((T, t_pad // 8), dtype=mask.dtype,
                         device=mask.device)
    onehot[torch.arange(T, device=mask.device), rank // 8] = 1.0
    return mask @ onehot


def _tile_liveness(counts, order, bn, n_pad):
    """(n_tiles, nb) slab liveness of the tiles of ``bn`` points in
    ``order``, from :func:`_slab_counts`."""
    N, nb = counts.shape
    m = counts.new_zeros((n_pad, nb))
    m[:N] = counts[order]
    return m.reshape(n_pad // bn, bn, nb).sum(dim=1) > 0.5


def _covers_from_liveness(lv: torch.Tensor):
    """Per-tile minimal cyclic 8-block window -> (starts8, covers8), int32
    on the liveness's device. The window leaves out the row's largest
    cyclic gap between live slabs, the first such gap in slab order; an
    empty row has start 0 and cover 0."""
    n_tiles, nb = lv.shape
    col = torch.arange(nb, device=lv.device)
    past = 2 * nb
    # first live slab at or after each slab, then strictly after it,
    # wrapping to the row's first live slab one turn on
    at_or_after = torch.where(lv, col, past).flip(1).cummin(1).values.flip(1)
    after = torch.cat([at_or_after[:, 1:],
                       at_or_after.new_full((n_tiles, 1), past)], dim=1)
    after = torch.where(after == past, at_or_after[:, :1] + nb, after)
    gap = torch.where(lv, after - col, -1)
    gmax = gap.max(dim=1).values
    first = torch.where(gap == gmax[:, None], col, nb).min(dim=1).values
    start = after.gather(1, first[:, None])[:, 0] % nb
    live = gmax > 0
    return (torch.where(live, start, 0).int(),
            torch.where(live, nb - gmax + 1, 0).int())


def _partition_sequence(covers8: torch.Tensor, max_groups: int,
                        t_pad: int):
    """Contiguous partition (no reorder) of tile covers into <= max_groups
    segments minimizing sum(len_g * max_g). Returns ((w_cells, lo, hi), ...)
    after one host read."""
    n = covers8.shape[0]
    if n == 0:
        return ((8, 0, 0),)
    c = covers8.long().clamp(1, t_pad // 8)
    k = torch.arange(n + 1, device=covers8.device)
    run = c.flip(0).cummax(0).values.flip(0)       # max(c[i:])
    dp = torch.cat([(n - k[:-1]) * run, c.new_zeros(1)]).double()
    seg_len = k[1:] - k[:-1, None]                 # [i, e - 1] -> e - i
    seg_max = torch.where(seg_len > 0, c, 0).cummax(dim=1).values
    pay = torch.where(seg_len > 0, (seg_len * seg_max).double(), torch.inf)
    ends = _cut_ends(pay, dp, max_groups)
    lo = torch.cat([ends.new_zeros(1), ends[:-1]])
    w = c.new_zeros(max_groups).scatter_reduce(
        0, torch.searchsorted(ends, k[:-1], right=True), c, "amax")
    rows = torch.stack([w * 8, lo, ends], dim=1).tolist()
    return tuple(tuple(r) for r in rows if r[1] < r[2])


def _group_tiles(covers8: torch.Tensor, max_groups: int):
    """Bucket tiles by cover width; tiles keep their angular order inside
    each bucket. Returns (tile_order, ((w_cells, lo, hi), ...)), the order
    on the covers' device, the groups after one host read."""
    if covers8.numel() == 0:
        return torch.zeros((0,), dtype=torch.long, device=covers8.device), ()
    buckets = _partition_widths(covers8, max_groups)
    tile_order = torch.argsort(buckets, stable=True)
    w, count = torch.unique_consecutive(buckets[tile_order],
                                        return_counts=True)
    hi = count.cumsum(0)
    rows = torch.stack([w * 8, hi - count, hi], dim=1).tolist()
    return tile_order, tuple(tuple(r) for r in rows)


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
    n_live = -(-N // block_np)
    # the co-visibility Gram on the host and the orderings it yields
    with span("deeparc.band.cooc"):
        cooc = (grid.mask.T @ grid.mask).cpu().numpy()     # (T, T)
        candidates = _cell_orderings(cooc, orderings)

    best = None
    for cell_perm in candidates:
        with span("deeparc.band.ordering"):
            cp = torch.as_tensor(cell_perm, device=dev)
            order = _point_order(grid.mask, cp)
            counts = _slab_counts(grid.mask, cp, t_pad)
            starts, covers = _covers_from_liveness(
                _tile_liveness(counts, order, block_np, n_pad))
            # selection metric: the PAID slot work after width bucketing,
            # over tiles that hold real points (this candidate's one host
            # read)
            work = int(_partition_widths(covers[:n_live], max_groups).sum())
        if best is None or work < best[0]:
            best = (work, cp, order, counts, starts, covers)
    work, cell_perm, order, counts, starts, covers = best
    n_tiles = n_pad // block_np
    if work * 8 >= max_frac * t_pad * n_live:
        return None

    with span("deeparc.band.tiles"):
        # width-bucketed tile reorder; tiles overlapping the padding stay
        # last
        n_full = N // block_np
        tile_order_full, lin_groups = _group_tiles(covers[:n_full],
                                                   max_groups)
        if n_full < n_tiles:
            w_tail = max(int(covers[n_full:].max()), 1) * 8
            lin_groups = lin_groups + ((w_tail, n_full, n_tiles),)
        starts = starts[torch.cat([tile_order_full,
                                   torch.arange(n_full, n_tiles, device=dev)])]
        n_rows = n_full * block_np
        order = torch.cat([
            order[:n_rows].reshape(n_full, block_np)[tile_order_full]
            .reshape(-1), order[n_rows:]])
        w_band = max(w for w, _, _ in lin_groups)

        # cost tiling on the FINAL point order: a contiguous sequence
        # partition
        starts_cost, covers_cost = _covers_from_liveness(
            _tile_liveness(counts, order, cost_block_np, n_pad))
        cost_groups = _partition_sequence(covers_cost, max_groups_cost,
                                          t_pad)
        w_cost = max(w for w, _, _ in cost_groups)
        # the slab counts are done with: free them before the permute's
        # copies of the planes
        del best, counts

    with span("deeparc.band.permute"):
        new_grid = _permuted(grid, order, cell_perm)
    with span("deeparc.band.stacks"):
        pxm_lin, pxm_cost = _gather_stacks(
            new_grid, starts, starts_cost, lin_groups, cost_groups,
            block_np, cost_block_np, max(w_band, w_cost))
    new_grid = dataclasses.replace(
        new_grid, band=(starts, starts_cost, pxm_lin, pxm_cost))
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
    with span("deeparc.band.permute"):
        mask = grid.mask[order][:, cp]
        moved = int(torch.count_nonzero((mask != 0)
                                        & (prep.grid.mask == 0)))
        if moved:
            raise ValueError(
                f"band_grid_update: {moved} live observations were dead at "
                f"prep time; the stored band covers are only valid for masks "
                f"that remove observations — run band_grid")
        g = dataclasses.replace(
            prep.grid, xy0=grid.xy0[order][:, cp],
            xy1=grid.xy1[order][:, cp], mask=mask,
            point_mask=grid.point_mask[order], band=())
    starts_d, starts_cost_d = prep.grid.band[0], prep.grid.band[1]
    with span("deeparc.band.stacks"):
        pxm_lin, pxm_cost = _gather_stacks(
            g, starts_d, starts_cost_d, prep.lin_groups, prep.cost_groups,
            prep.block_np, prep.cost_block_np,
            max(prep.w_band, prep.w_band_cost))
    g = dataclasses.replace(g, band=(starts_d, starts_cost_d, pxm_lin,
                                     pxm_cost))
    return prep._replace(grid=g)

"""Tile-engine kernels: the fused bucket linearization and the PCG sweeps,
as CUDA kernels for Hopper, their plain PyTorch versions, and the slot
bins the kernels reduce through.

PyTorch port of ``deeparc_tpu/kernels/tile_pallas.py``. Three wrappers keep
the reference's names, positional signatures and returns:

  tile_linearize_local -> (cost, pout, r_t, jx_t, jcam_t, gc, hc)
  tile_sweep_local     -> (n_chunks, V_local, 18) bins, or (Nb, 3) E v rows
  tile_sweep           -> (V, 18) cell values, or (Nb, 3) E v rows

A wrapper given CUDA tensors launches the hand-written kernels
(``csrc/tile.cu``) and raises if it cannot; given CPU tensors it runs the
plain version (``*_plain``). Each wrapper counts its launches in a plain
``int`` attribute, ``launches``.

Layout (as in the reference): TRANSPOSED planes, rows (points) in columns.
For a bucket of Nb rows and W slots:

    cell_t  (W, Nb)     int32 cell id per (slot, row): chunk-LOCAL ids for
                        the ``*_local`` functions, global ids for tile_sweep
    jcam_t  (36W, Nb)   row w*36 + k*18 + j = d r_k / d cam_j of slot w
    jx_t    (6W, Nb)    row w*6 + k*3 + i   = d r_k / d X_i of slot w
    r_t     (2W, Nb)    row 2w + k          = r_k of slot w
    binv_t  (9, Nb), gp_t (3, Nb), pout (12, Nb): g_p then row-major H_pp

The rows of a bucket are cut into n_chunks chunks of B = Nb / n_chunks
rows; a chunk's local cell l is global cell ``chunk_cells[chunk, l]``.

Binning a per-slot value into its cell is a reduction across rows into
data-dependent cells. The kernels do it without float atomics, through
:class:`SlotBins`: the flat slot ids (w * Nb + p) sorted by bin (chunk *
V_local + local id, or the global cell id), cut into segments of at most
``SEGMENT`` slots, and cut into runs of bins (``SlotBins.runs``: a chunk's
bins, or those of at most ``RUN_SLOTS`` of its sorted slots). The
linearize's bin pass sums one run per block, each bin over its slots in
list order straight into its row. Every run gives the same bits. The
sweeps (rhs/matvec) read a sorted copy of jcam, built once
per LM step, and write each slot's scalars at its sorted position
(``SlotBins.pos``), so their bin passes read adjacent addresses:
``tile_sweep`` from the slot rows (:func:`sort_jcam`), summing per segment
then per cell; ``tile_sweep_local`` from its transposed planes
(:func:`sort_jcam_planes`), its bin pass one block per chunk summing the
chunk's bins into their final rows, which :func:`sum_chunk_bins` then
sums into the global cells in one fixed order. The same gather kernel
(:func:`sum_rows`, over a :func:`gather_map` built once per layout) takes
the tile step's other sums on the card, so one step repeats bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeparc_tpu_torch.kernels.rig_grid import (
    _DTYPE_IDS,
    _LOSS_IDS,
    _dispatch,
    _slot_products,
)
from deeparc_tpu_torch.utils.debug import kernel_boundary

# the sweep kernels take buckets up to this width; wider buckets (the heavy
# tail of a track distribution) run the torch sweeps (solver/tiles._e_sweep)
MAX_KERNEL_WIDTH = 64
# the fused linearize takes buckets up to this width (the reference's cap)
MAX_LIN_WIDTH = 32

PACKED_DIM = 78
# most slots one warp sums before its bin spills into a further segment
SEGMENT = 256
# a run of bins (one block of the linearize's bin pass) holds the bins of
# one chunk that start within RUN_SLOTS sorted slots, at most RUN_BINS of
# them (csrc/tile.cu LB_BINS)
RUN_SLOTS = 8192
RUN_BINS = 1024
# slots the plain versions process at once (bounds their temporaries)
_PLAIN_SLOTS = 1 << 19
_MODES = {"rhs": 0, "matvec": 1, "edot": 2}

# packed-table column of each slot-table column of kernels/rig_grid.py: the
# tile table (solver/tiles.pack_cells) keeps t_i, t_o before the right
# Jacobians, the grid table after them; everything else coincides
_TILE_COL = (list(range(27)) + list(range(33, 51)) + list(range(27, 33))
             + list(range(51, 78)))


def pack_bucket_planes(j_x, j_cam, cell):
    """((Nb,W,2,3), (Nb,W,2,18), (Nb,W)) -> transposed plane tensors."""
    Nb, W = cell.shape
    jcam_t = j_cam.permute(1, 2, 3, 0).reshape(W * 36, Nb)
    jx_t = j_x.permute(1, 2, 3, 0).reshape(W * 6, Nb)
    return cell.T.contiguous(), jcam_t.contiguous(), jx_t.contiguous()


class SlotBins(NamedTuple):
    """A bucket's slots grouped by bin, for the kernels' reductions."""

    order: torch.Tensor      # (W*Nb,) int32 flat slot ids, sorted by bin
    seg_start: torch.Tensor  # (n_seg + 1,) int32 segment bounds in ``order``
    bin_seg: torch.Tensor    # (n_bins + 1,) int32 first segment of each bin
    n_bins: int
    pos: torch.Tensor        # (W*Nb,) int32 inverse of ``order``: a slot's
                             # position in the sorted list
    runs: torch.Tensor       # (n_runs + 1,) int32 first bin of each run
    gather: tuple = ()       # local bins: (cstart (V+1,), src) int32, the
                             # non-empty bins of each global cell in bin
                             # order (chunk_gather); () for global bins


def gather_map(dst: torch.Tensor, n_out: int, max_len: int = 0) -> tuple:
    """The fixed-order map of a row sum ``out[o] = sum of part[s] over
    dst[s] == o``: (cstart (n_out + 1,), src) int32, output row o's source
    rows ``src[cstart[o]:cstart[o + 1]]`` in increasing order. On the card
    the gather kernel (``csrc/tile.cu``, ``gather_cells``) sums them in
    one fixed order: stripes of every 8th source (every 32nd when a row
    is one value), each in list order, then the stripes in order. Sources
    with ``dst < 0`` are left out. Depends on the ids only, so it is built
    once per layout.

    With ``max_len``, where a row has more sources, the rows are cut into
    segments of at most ``max_len`` sources, each summed by its own block,
    and the map is (cstart, src, seg_start, seg): the segments' map, then
    the map of each output row to its segments, which a second pass adds
    in order. One block no longer sums a long row alone."""
    dst = dst.reshape(-1).long()
    keep = (dst >= 0).nonzero()[:, 0]
    d = dst[keep]
    src = keep[torch.argsort(d, stable=True)].to(torch.int32)
    count = torch.bincount(d, minlength=n_out)
    cstart = _starts(count)
    if not max_len or not count.numel() or int(count.max()) <= max_len:
        return cstart.to(torch.int32), src
    n_seg = (count + max_len - 1) // max_len
    seg_start = _starts(n_seg)
    n = int(seg_start[-1])
    row = torch.repeat_interleave(
        torch.arange(n_out, device=dst.device), n_seg)
    first = cstart[row] + (torch.arange(n, device=dst.device)
                           - seg_start[row]) * max_len
    return (torch.cat([first, cstart[-1:]]).to(torch.int32), src,
            seg_start.to(torch.int32),
            torch.arange(n, dtype=torch.int32, device=dst.device))


def _starts(count: torch.Tensor) -> torch.Tensor:
    """(n + 1,) running starts of n counts."""
    out = torch.zeros(count.numel() + 1, dtype=torch.long,
                      device=count.device)
    out[1:] = torch.cumsum(count, 0)
    return out


def chunk_gather(bins: SlotBins, chunk_cells: torch.Tensor, V: int) -> tuple:
    """The fixed-order map from a locality bucket's per-chunk bins (chunk *
    V_local + local id) to the V global cells: for cell v, the non-empty
    bins ``src[cstart[v]:cstart[v + 1]]`` in increasing bin order, which
    :func:`sum_chunk_bins` sums in one fixed order. An empty bin is zero in
    the linearize's and the sweeps' bins alike, so one map serves both.
    Built once per layout."""
    nonempty = bins.bin_seg[1:] > bins.bin_seg[:-1]
    return gather_map(torch.where(nonempty, chunk_cells.reshape(-1).long(),
                                  -1), V)


def slot_bins(cell_t: torch.Tensor, n_chunks: int, n_cells: int) -> SlotBins:
    """The bins of a (W, Nb) cell plane: bin = chunk * n_cells + cell, with
    ``n_chunks`` chunks of Nb / n_chunks rows (1 chunk for global ids).
    Depends on the cell ids only, so it is built once per layout; slots
    whose mask is 0 carry zeros and cost work but no error."""
    W, Nb = cell_t.shape
    dev = cell_t.device
    B = Nb // n_chunks
    chunk = torch.arange(Nb, device=dev) // B
    key = (chunk[None, :] * n_cells + cell_t.long()).reshape(-1)
    order = torch.argsort(key, stable=True)
    n_bins = n_chunks * n_cells
    counts = torch.bincount(key, minlength=n_bins)
    n_seg_bin = (counts + SEGMENT - 1) // SEGMENT
    bin_seg = torch.zeros(n_bins + 1, dtype=torch.long, device=dev)
    bin_seg[1:] = torch.cumsum(n_seg_bin, 0)
    bin_lo = torch.cumsum(counts, 0) - counts
    seg_bin = torch.repeat_interleave(torch.arange(n_bins, device=dev),
                                      n_seg_bin)
    seg_lo = (bin_lo[seg_bin]
              + (torch.arange(seg_bin.numel(), device=dev)
                 - bin_seg[seg_bin]) * SEGMENT)
    seg_start = torch.cat([seg_lo, torch.full((1,), key.numel(),
                                              dtype=torch.long, device=dev)])
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=dev)
    i32 = lambda t: t.to(torch.int32).contiguous()
    return SlotBins(order=i32(order), seg_start=i32(seg_start),
                    bin_seg=i32(bin_seg), n_bins=n_bins, pos=i32(pos),
                    runs=i32(bin_runs(bin_lo, counts, n_cells)))


def bin_runs(bin_lo: torch.Tensor, counts: torch.Tensor,
             n_cells: int) -> torch.Tensor:
    """(n_runs + 1,) first bin of each run: the bins of one chunk (bins
    chunk * n_cells ...) whose first sorted slot ``bin_lo`` lies in one
    window of ``RUN_SLOTS`` slots from the chunk's first (an empty bin at
    a chunk's end stays in its last window), cut again every ``RUN_BINS``
    bins. A run's bins fill one range of sorted positions."""
    n_bins = bin_lo.numel()
    b = torch.arange(n_bins, device=bin_lo.device)
    chunk = b // n_cells
    first_slot = bin_lo[chunk * n_cells]
    chunk_slots = counts.reshape(-1, n_cells).sum(1)[chunk]
    window = (torch.minimum(bin_lo - first_slot, chunk_slots - 1).clamp(min=0)
              // RUN_SLOTS)
    key = chunk * (int(window.max()) + 1 if n_bins else 1) + window
    first = torch.searchsorted(key, key)
    starts = b[(b - first) % RUN_BINS == 0]
    return torch.cat([starts, torch.full((1,), n_bins, dtype=b.dtype,
                                         device=b.device)])


def sort_jcam_plain(j_cam: torch.Tensor, bins: SlotBins,
                    dtype=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`sort_jcam`."""
    Nb, W = j_cam.shape[:2]
    f = bins.order.long()
    rows = j_cam.reshape(Nb * W, 36).index_select(0, (f % Nb) * W + f // Nb)
    out = torch.empty((36, Nb * W), dtype=dtype or j_cam.dtype,
                      device=j_cam.device)
    return out.copy_(rows.T)


@kernel_boundary
def sort_jcam(j_cam: torch.Tensor, bins: SlotBins, dtype=None) -> torch.Tensor:
    """A bucket's camera Jacobians in the bins' slot order, as (36, W*Nb)
    planes: column i holds the 36 values of slot ``order[i]`` (flat id
    w * Nb + p), so the slots of one segment are adjacent. ``j_cam`` is the
    (Nb, W, 2, 18) slot rows (each slot's 36 values contiguous, so the
    gather reads whole rows); ``dtype`` is the planes' storage dtype
    (default ``j_cam``'s; bf16 rounds as ``Tensor.to`` does).
    :func:`tile_sweep` reads it in rhs/matvec on the card; it depends on
    the Jacobians, so it is built once per LM step. On CUDA tensors a
    gather kernel builds it (``csrc/tile.cu``, ``sort_rows``)."""
    if not _dispatch(j_cam, "sort_jcam"):
        return sort_jcam_plain(j_cam, bins, dtype)
    from deeparc_tpu_torch.kernels.build import check, library

    Nb, W = j_cam.shape[:2]
    if j_cam.shape[2:] != (2, 18):
        raise ValueError(f"j_cam must be (Nb, W, 2, 18), not "
                         f"{tuple(j_cam.shape)}")
    j_cam = j_cam.contiguous()
    dt = _check_inputs(j_cam.dtype, (), (j_cam,))
    _check_bins(bins, W, Nb, bins.n_bins, j_cam.device)
    out = torch.empty((36, Nb * W), dtype=dtype or j_cam.dtype,
                      device=j_cam.device)
    sort_jcam.launches += 1
    check(library().tile_sort_jcam(
        dt, _plane_id(out, j_cam.dtype), j_cam.data_ptr(),
        bins.order.data_ptr(), Nb, W, out.data_ptr(), _stream(j_cam.device)),
        "tile_sort_jcam")
    return out


def sort_jcam_planes_plain(jcam_t: torch.Tensor, bins: SlotBins,
                           n_chunks: int = 1) -> torch.Tensor:
    """Plain PyTorch version of :func:`sort_jcam_planes`."""
    W, Nb = jcam_t.shape[0] // 36, jcam_t.shape[1]
    f = bins.order.long()
    return jcam_t.reshape(W, 36, Nb)[f // Nb, :, f % Nb].T.contiguous()


@kernel_boundary
def sort_jcam_planes(jcam_t: torch.Tensor, bins: SlotBins,
                     n_chunks: int) -> torch.Tensor:
    """A locality bucket's transposed jcam planes (36W, Nb) in its bins'
    slot order, as (36, W*Nb): column i holds the 36 values of slot
    ``order[i]`` (flat id w * Nb + p), copied bit for bit in the planes'
    storage dtype, so that :func:`tile_sweep_local`'s row pass and bin
    pass apply the same E. The bins are per chunk of Nb / n_chunks rows,
    so a chunk's slots fill one run of the sorted positions.
    :func:`tile_sweep_local` reads it in rhs/matvec on the card; it depends
    on the Jacobians, so it is built once per LM step. On CUDA tensors a
    staged gather kernel builds it (``csrc/tile.cu``, ``sort_planes``)."""
    if not _dispatch(jcam_t, "sort_jcam_planes"):
        return sort_jcam_planes_plain(jcam_t, bins, n_chunks)
    from deeparc_tpu_torch.kernels.build import check, library

    W, Nb = jcam_t.shape[0] // 36, jcam_t.shape[1]
    if jcam_t.shape[0] != 36 * W or not jcam_t.is_contiguous():
        raise ValueError(f"jcam_t must be contiguous (36W, Nb), not "
                         f"{tuple(jcam_t.shape)}")
    B = _rows_of_chunks(Nb, n_chunks)
    _check_bins(bins, W, Nb, bins.n_bins, jcam_t.device)
    out = torch.empty((36, W * Nb), dtype=jcam_t.dtype, device=jcam_t.device)
    sort_jcam_planes.launches += 1
    check(library().tile_sort_planes(
        jcam_t.element_size(), jcam_t.data_ptr(), bins.order.data_ptr(), W,
        Nb, B, out.data_ptr(), _stream(jcam_t.device)), "tile_sort_planes")
    return out


def sum_rows_plain(part: torch.Tensor, dst: torch.Tensor,
                   n_out: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`sum_rows`."""
    out = torch.zeros((n_out,) + part.shape[1:], dtype=part.dtype,
                      device=part.device)
    return out.index_add_(0, dst.reshape(-1).long(), part)


@kernel_boundary
def sum_rows(part: torch.Tensor, dst: torch.Tensor, n_out: int,
             gather: tuple = ()) -> torch.Tensor:
    """The rows of ``part`` (n_src, ...) summed into (n_out, ...) by
    ``dst``: ``out[o] = sum of part[s] over dst[s] == o``, rows of at most
    192 values. On the card a gather kernel sums each output row's sources
    in one fixed order through ``gather`` (:func:`gather_map` over all
    n_out rows, built once per layout; it may leave out sources whose rows
    are zero), in a second pass over the segments where the map cuts long
    rows: no float atomics, the same bits every run. The plain version is
    ``index_add_`` over ``dst``."""
    if not _dispatch(part, "sum_rows"):
        return sum_rows_plain(part, dst, n_out)
    if len(gather) not in (2, 4):
        raise ValueError("sum_rows on the card needs the layout's "
                         "fixed-order map (kernels.tile.gather_map)")
    flat = part.reshape(part.shape[0], -1).contiguous()
    if len(gather) == 4:
        flat = _gather_cells(flat, gather[0], gather[1], gather[3].numel())
        gather = gather[2:]
    out = _gather_cells(flat, gather[0], gather[1], n_out)
    return out.reshape((n_out,) + part.shape[1:])


def _gather_cells(flat, cstart, src, n_out):
    """One launch of the gather kernel: (n_src, F) rows into (n_out, F)."""
    from deeparc_tpu_torch.kernels.build import check, library

    F = flat.shape[1]
    if cstart.numel() != n_out + 1 or F > 192 or src.numel() > flat.shape[0]:
        raise ValueError(f"a map of {cstart.numel() - 1} rows from "
                         f"{src.numel()} sources does not fit "
                         f"{flat.shape[0]} rows of {F} values into {n_out} "
                         f"rows (at most 192 values)")
    dt = _check_inputs(flat.dtype, (cstart, src), (flat,))
    out = torch.empty((n_out, F), dtype=flat.dtype, device=flat.device)
    sum_rows.launches += 1
    check(library().tile_gather_cells(
        dt, flat.data_ptr(), cstart.data_ptr(), src.data_ptr(), n_out, F,
        out.data_ptr(), _stream(flat.device)), "tile_gather_cells")
    return out


def sum_chunk_bins(part: torch.Tensor, chunk_cells: torch.Tensor, V: int,
                   bins: SlotBins | None = None) -> torch.Tensor:
    """A locality bucket's per-chunk bins (n_chunks, V_local, F) summed
    into the global (V, F) cells through ``chunk_cells``: F = 18 for the
    sweeps' bins and the linearize's gradient bins, 171 for its Gram
    bins. :func:`sum_rows` over the bins' ``gather`` map
    (:func:`chunk_gather`), which the card needs."""
    gather = bins.gather if isinstance(bins, SlotBins) else ()
    return sum_rows(part.reshape(-1, part.shape[-1]), chunk_cells, V, gather)


def _check_bins(bins, W, Nb, n_bins, dev):
    """The card path bins through the layout's own slot lists, built once
    with the layout (``solver.tiles.with_bins``); it never builds them."""
    if not isinstance(bins, SlotBins):
        raise ValueError("the tile kernels need the bucket's slot bins "
                         "(TileBucket.bins, from solver.tiles.with_bins)")
    if bins.order.numel() != W * Nb or bins.n_bins != n_bins:
        raise ValueError(f"slot bins of {bins.order.numel()} slots and "
                         f"{bins.n_bins} bins do not fit a ({W}, {Nb}) "
                         f"plane with {n_bins} bins")
    if bins.order.device != dev:
        raise TypeError(f"slot bins on {bins.order.device}, expected {dev}")
    return bins


def _rows_of_chunks(Nb, n_chunks):
    if n_chunks <= 0 or Nb % n_chunks:
        raise ValueError(f"{Nb} rows do not split into {n_chunks} chunks")
    return Nb // n_chunks


def _pieces(Nb, W):
    """Row ranges of the plain versions, ~_PLAIN_SLOTS slots each."""
    step = max(1, _PLAIN_SLOTS // W)
    for r0 in range(0, Nb, step):
        yield r0, min(Nb, r0 + step)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def tile_linearize_local_plain(pts_pack, cell_t, xy0_t, xy1_t, mask_t, tables,
                               loss="trivial", loss_scale=0.5, block_n=256,
                               plane_dtype=None):
    """Plain PyTorch version of :func:`tile_linearize_local`: each slot's
    table row is gathered by its local id (the reference selects it with a
    one-hot matmul), the slot math is the grid engine's (``_slot_products``)
    on the tile table's columns, and the bins are ``index_add_``."""
    W, Nb = cell_t.shape
    n_chunks, Vl, _ = tables.shape
    B = _rows_of_chunks(Nb, n_chunks)
    dtype, dev = xy0_t.dtype, xy0_t.device
    pdt = plane_dtype or dtype
    pout = torch.empty((12, Nb), dtype=dtype, device=dev)
    r_t = torch.empty((2 * W, Nb), dtype=pdt, device=dev)
    jx_t = torch.empty((6 * W, Nb), dtype=pdt, device=dev)
    jcam_t = torch.empty((36 * W, Nb), dtype=pdt, device=dev)
    gc = torch.zeros((n_chunks * Vl, 18), dtype=dtype, device=dev)
    hc = torch.zeros((n_chunks * Vl, 171), dtype=dtype, device=dev)
    cost = torch.zeros((), dtype=dtype, device=dev)
    iu, ju = torch.triu_indices(18, 18, device=dev)
    for r0, r1 in _pieces(Nb, W):
        n = r1 - r0
        chunk = torch.arange(r0, r1, device=dev) // B
        loc = cell_t[:, r0:r1].long()
        tb = tables[chunk[None, :], loc]                      # (W, n, 78)
        col = lambda c: tb[..., _TILE_COL[c]]
        X = [pts_pack[a, r0:r1][None, :] for a in range(3)]
        pf = [pts_pack[3 + a, r0:r1][None, :] for a in range(3)]
        c_val, rr0, rr1, jx_f, P = _slot_products(
            col, X, pf, xy0_t[:, r0:r1], xy1_t[:, r0:r1], mask_t[:, r0:r1],
            loss, loss_scale, zguard=True)
        cost = cost + c_val
        J = torch.stack([torch.stack(jx_f[k]) for k in range(2)])  # 2,3,W,n
        Pk = torch.stack([torch.stack(P[k]) for k in range(2)])    # 2,18,W,n
        r_t[:, r0:r1] = torch.stack([rr0, rr1], 1).reshape(2 * W, n).to(pdt)
        jx_t[:, r0:r1] = J.permute(2, 0, 1, 3).reshape(6 * W, n).to(pdt)
        jcam_t[:, r0:r1] = Pk.permute(2, 0, 1, 3).reshape(36 * W, n).to(pdt)
        pout[0:3, r0:r1] = (J[0] * rr0 + J[1] * rr1).sum(1)
        pout[3:12, r0:r1] = torch.einsum("kawn,kbwn->abn", J, J).reshape(9, n)
        key = (chunk[None, :] * Vl + loc).reshape(-1)
        g18 = Pk[0] * rr0 + Pk[1] * rr1                           # 18,W,n
        h171 = Pk[0][iu] * Pk[0][ju] + Pk[1][iu] * Pk[1][ju]       # 171,W,n
        gc.index_add_(0, key, g18.reshape(18, -1).T)
        hc.index_add_(0, key, h171.reshape(171, -1).T)
    return (cost, pout, r_t, jx_t, jcam_t, gc.reshape(n_chunks, Vl, 18),
            hc.reshape(n_chunks, Vl, 171))


def _sweep_plain(cell_t, jcam_t, jx_t, binv_t, gp_t, v_of, mode, n_chunks,
                 n_cells):
    """Shared plain sweep: ``v_of(chunk, cell)`` gives each slot's (W, n,
    18) v values; bins are chunk * n_cells + cell."""
    W, Nb = cell_t.shape
    B = _rows_of_chunks(Nb, n_chunks)
    dtype, dev = binv_t.dtype, binv_t.device
    if mode not in _MODES:
        raise ValueError(f"unknown sweep mode {mode!r}")
    if mode == "edot":
        ev_out = torch.empty((Nb, 3), dtype=dtype, device=dev)
    else:
        out = torch.zeros((n_chunks * n_cells, 18), dtype=dtype, device=dev)
    for r0, r1 in _pieces(Nb, W):
        n = r1 - r0
        chunk = torch.arange(r0, r1, device=dev) // B
        cell = cell_t[:, r0:r1].long()
        jc = jcam_t[:, r0:r1].to(dtype).reshape(W, 2, 18, n)
        jx = jx_t[:, r0:r1].to(dtype).reshape(W, 2, 3, n)
        if mode == "rhs":
            rhs = gp_t[:, r0:r1]
        else:
            t = torch.einsum("wkjn,wnj->wkn", jc, v_of(chunk, cell))
            rhs = torch.einsum("wkin,wkn->in", jx, t)
            if mode == "edot":
                ev_out[r0:r1] = rhs.T
                continue
        wv = torch.einsum("ijn,jn->in", binv_t[:, r0:r1].reshape(3, 3, n),
                          rhs)
        t2 = torch.einsum("wkin,in->wkn", jx, wv)
        u = torch.einsum("wkjn,wkn->wnj", jc, t2)
        out.index_add_(0, (chunk[None, :] * n_cells + cell).reshape(-1),
                       u.reshape(-1, 18))
    if mode == "edot":
        return ev_out
    return out.reshape(n_chunks, n_cells, 18)


def tile_sweep_local_plain(cell_t, jcam_t, jx_t, binv_t, gp_t, v_locals,
                           mode="matvec", block_n=256):
    """Plain PyTorch version of :func:`tile_sweep_local`."""
    n_chunks, _, Vl = v_locals.shape
    v_of = lambda chunk, cell: v_locals.to(binv_t.dtype)[chunk[None, :], :,
                                                         cell]
    return _sweep_plain(cell_t, jcam_t, jx_t, binv_t, gp_t, v_of, mode,
                        n_chunks, Vl)


def tile_sweep_plain(cell_t, jcam_t, jx_t, binv_t, gp_t, v_cells,
                     mode="matvec", block_n=256):
    """Plain PyTorch version of :func:`tile_sweep`."""
    V = v_cells.shape[0]
    v_of = lambda chunk, cell: v_cells.to(binv_t.dtype)[cell]
    out = _sweep_plain(cell_t, jcam_t, jx_t, binv_t, gp_t, v_of, mode, 1, V)
    return out if mode == "edot" else out[0]


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _plane_id(planes, dtype):
    """0 = planes stored in the working dtype, 1 = bfloat16."""
    if planes.dtype == dtype:
        return 0
    if planes.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"planes of {planes.dtype} with working dtype {dtype}")


def _check_inputs(dtype, ints, floats, planes=()):
    """Device, dtype and contiguity checks before pointers reach a kernel."""
    if dtype not in _DTYPE_IDS:
        raise TypeError(f"tile kernels take float32 or float64, not {dtype}")
    dev = floats[0].device
    for t in ints + floats + planes:
        if t.device != dev:
            raise TypeError(f"kernel input on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"index input of {t.dtype}, expected int32")
    for t in floats:
        if t.dtype != dtype:
            raise TypeError(f"kernel input of {t.dtype}, expected {dtype}")
    return _DTYPE_IDS[dtype]


def _threads(block_n):
    return max(32, min(256, (int(block_n) // 32) * 32))


def _cuda_linearize(pts_pack, cell_t, xy0_t, xy1_t, mask_t, tables, loss,
                    loss_scale, block_n, plane_dtype, bins):
    from deeparc_tpu_torch.kernels.build import check, library

    lib = library()
    W, Nb = cell_t.shape
    n_chunks, Vl, _ = tables.shape
    B = _rows_of_chunks(Nb, n_chunks)
    dtype, dev = xy0_t.dtype, xy0_t.device
    if loss not in _LOSS_IDS:
        raise ValueError(f"unknown loss {loss!r}")
    if W > MAX_LIN_WIDTH:
        raise ValueError(f"tile_linearize_local takes W <= {MAX_LIN_WIDTH}, "
                         f"not {W}")
    if tables.shape[2] != PACKED_DIM or pts_pack.shape != (8, Nb):
        raise ValueError("tables must be (n_chunks, V_local, 78) and "
                         "pts_pack (8, Nb)")
    dt = _check_inputs(dtype, (cell_t,), (pts_pack, xy0_t, xy1_t, mask_t,
                                          tables))
    pdt = plane_dtype or dtype
    pid = _plane_id(torch.empty(0, dtype=pdt), dtype)
    bins = _check_bins(bins, W, Nb, n_chunks * Vl, dev)
    threads = _threads(block_n)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-Nb // threads), 4 * sms))
    pout = torch.empty((12, Nb), dtype=dtype, device=dev)
    r_t = torch.empty((2 * W, Nb), dtype=pdt, device=dev)
    jx_t = torch.empty((6 * W, Nb), dtype=pdt, device=dev)
    jcam_t = torch.empty((36 * W, Nb), dtype=pdt, device=dev)
    partial_cost = torch.empty((grid,), dtype=dtype, device=dev)
    gc = torch.empty((n_chunks, Vl, 18), dtype=dtype, device=dev)
    hc = torch.empty((n_chunks, Vl, 171), dtype=dtype, device=dev)
    cost = torch.empty((), dtype=dtype, device=dev)
    stream = _stream(dev)
    ls = _LOSS_IDS[loss]
    common = (pts_pack.data_ptr(), cell_t.data_ptr(), xy0_t.data_ptr(),
              xy1_t.data_ptr(), mask_t.data_ptr(), tables.data_ptr())
    tile_linearize_local.launches += 1
    check(lib.tile_linearize_rows(
        dt, pid, ls, *common, W, Nb, B, Vl, float(loss_scale), threads, grid,
        pout.data_ptr(), r_t.data_ptr(), jx_t.data_ptr(), jcam_t.data_ptr(),
        partial_cost.data_ptr(), stream), "tile_linearize_rows")
    check(lib.tile_linearize_bins(
        dt, ls, *common, bins.order.data_ptr(), bins.seg_start.data_ptr(),
        bins.bin_seg.data_ptr(), bins.runs.data_ptr(), bins.runs.numel() - 1,
        Nb, B, Vl, float(loss_scale), gc.data_ptr(), hc.data_ptr(), stream),
        "tile_linearize_bins")
    check(lib.tile_reduce_cost(dt, partial_cost.data_ptr(), grid,
                               cost.data_ptr(), stream), "tile_reduce_cost")
    return cost, pout, r_t, jx_t, jcam_t, gc, hc


def _cuda_sweep(cell_t, jcam_t, jx_t, binv_t, gp_t, v, mode, block_n, local,
                n_chunks, n_cells, bins, counter, sorted_jcam=None):
    from deeparc_tpu_torch.kernels.build import check, library

    lib = library()
    W, Nb = cell_t.shape
    B = _rows_of_chunks(Nb, n_chunks)
    dtype, dev = binv_t.dtype, binv_t.device
    if mode not in _MODES:
        raise ValueError(f"unknown sweep mode {mode!r}")
    if W > MAX_KERNEL_WIDTH:
        raise ValueError(f"the sweep kernels take W <= {MAX_KERNEL_WIDTH}, "
                         f"not {W}")
    if jcam_t.shape != (36 * W, Nb) or jx_t.shape != (6 * W, Nb):
        raise ValueError("plane shapes do not match the cell plane")
    v = v.to(dtype).contiguous()
    dt = _check_inputs(dtype, (cell_t,), (binv_t, gp_t, v), (jcam_t, jx_t))
    pid = _plane_id(jcam_t, dtype)
    if _plane_id(jx_t, dtype) != pid:
        raise TypeError("jcam_t and jx_t must share one storage dtype")
    if mode != "edot":
        _check_bins(bins, W, Nb, n_chunks * n_cells, dev)
    threads = _threads(block_n)
    stream = _stream(dev)
    if mode != "edot":
        _check_sorted(sorted_jcam, jcam_t, W * Nb, "tile_sweep_local" if local
                      else "tile_sweep")
        if local:
            return _cuda_local_sweep(lib, check, dt, pid, mode, cell_t,
                                     jcam_t, jx_t, binv_t, gp_t, v, B,
                                     n_chunks, n_cells, bins, sorted_jcam,
                                     counter, stream)
        return _cuda_global_sweep(lib, check, dt, pid, mode, cell_t, jcam_t,
                                  jx_t, binv_t, gp_t, v, threads, bins,
                                  sorted_jcam, counter, stream)
    ev = torch.empty((Nb, 3), dtype=dtype, device=dev)
    counter.launches += 1
    check(lib.tile_edot(dt, pid, int(local), cell_t.data_ptr(),
                        jcam_t.data_ptr(), jx_t.data_ptr(), v.data_ptr(), W,
                        Nb, B, n_cells, threads, ev.data_ptr(), stream),
          "tile_edot")
    return ev


def _check_sorted(sorted_jcam, jcam_t, n_slots, name):
    """The sorted jcam copy the rhs/matvec kernels read: (36, W*Nb), the
    planes' storage dtype, on their device."""
    if not isinstance(sorted_jcam, torch.Tensor):
        raise ValueError(f"{name} on the card needs the bucket's sorted jcam "
                         f"copy in rhs/matvec")
    if (sorted_jcam.shape != (36, n_slots) or sorted_jcam.dtype != jcam_t.dtype
            or sorted_jcam.device != jcam_t.device
            or not sorted_jcam.is_contiguous()):
        raise ValueError(f"sorted jcam {tuple(sorted_jcam.shape)} "
                         f"{sorted_jcam.dtype} on {sorted_jcam.device} does "
                         f"not fit (36, {n_slots}) {jcam_t.dtype} on "
                         f"{jcam_t.device}")


def _cuda_local_sweep(lib, check, dt, pid, mode, cell_t, jcam_t, jx_t, binv_t,
                      gp_t, v, B, n_chunks, Vl, bins, sorted_jcam, counter,
                      stream):
    """tile_sweep_local in rhs/matvec: the row pass writes each slot's
    jx . w at its sorted position, then one block per chunk sums the
    chunk's bins from the chunk-sorted jcam copy into their final rows."""
    W, Nb = cell_t.shape
    dtype, dev = binv_t.dtype, binv_t.device
    t2 = torch.empty((W * Nb, 2), dtype=dtype, device=dev)
    out = torch.empty((n_chunks, Vl, 18), dtype=dtype, device=dev)
    counter.launches += 1
    check(lib.tile_lsweep(
        dt, pid, _MODES[mode], cell_t.data_ptr(), jcam_t.data_ptr(),
        jx_t.data_ptr(), binv_t.data_ptr(), gp_t.data_ptr(), v.data_ptr(),
        bins.pos.data_ptr(), sorted_jcam.data_ptr(),
        bins.seg_start.data_ptr(), bins.bin_seg.data_ptr(), W, Nb, B, Vl,
        t2.data_ptr(), out.data_ptr(), stream), "tile_lsweep")
    return out


def _cuda_global_sweep(lib, check, dt, pid, mode, cell_t, jcam_t, jx_t,
                       binv_t, gp_t, v, threads, bins, sorted_jcam, counter,
                       stream):
    """tile_sweep in rhs/matvec: the row pass scatters each slot's jx . w
    to its sorted position; the bin pass reads them and the cell-sorted
    jcam copy coalesced."""
    W, Nb = cell_t.shape
    dtype, dev = binv_t.dtype, binv_t.device
    n_seg = bins.seg_start.numel() - 1
    t2 = torch.empty((W * Nb, 2), dtype=dtype, device=dev)
    partial = torch.empty((max(n_seg, 1), 18), dtype=dtype, device=dev)
    out = torch.empty((1, bins.n_bins, 18), dtype=dtype, device=dev)
    counter.launches += 1
    check(lib.tile_gsweep(
        dt, pid, _MODES[mode], cell_t.data_ptr(), jcam_t.data_ptr(),
        jx_t.data_ptr(), binv_t.data_ptr(), gp_t.data_ptr(), v.data_ptr(),
        bins.pos.data_ptr(), sorted_jcam.data_ptr(),
        bins.seg_start.data_ptr(), n_seg, W, Nb, threads, t2.data_ptr(),
        partial.data_ptr(), stream), "tile_gsweep")
    check(lib.tile_reduce_bins(dt, partial.data_ptr(), bins.bin_seg.data_ptr(),
                               bins.n_bins, 18, out.data_ptr(), stream),
          "tile_reduce_bins")
    return out


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------


@kernel_boundary
def tile_linearize_local(pts_pack, cell_t, xy0_t, xy1_t, mask_t, tables,
                         loss="trivial", loss_scale=0.5, block_n=256,
                         plane_dtype=None, bins=None):
    """Fused linearization over one locality-blocked bucket.

    ``pts_pack`` is (8, Nb): rows 0:3 points^T, 3:6 point-freeze^T (6:8
    unused). ``cell_t`` carries LOCAL ids (W, Nb), ``tables`` the per-chunk
    packed cell tables (n_chunks, V_local, 78). Returns (cost, pout (12,
    Nb), r_t (2W, Nb), jx_t (6W, Nb), jcam_t (36W, Nb), gc (n_chunks,
    V_local, 18), hc (n_chunks, V_local, 171) upper-triangle Gram bins).
    ``plane_dtype`` (e.g. ``torch.bfloat16``) stores the r/jx/jcam planes
    in that dtype; pout, gc, hc and the cost stay in the working dtype.
    ``bins`` is the bucket's :func:`slot_bins` (``TileBucket.bins``); the
    kernels need it, the plain version ignores it.
    ``block_n`` is the row kernel's threads per block."""
    if not _dispatch(xy0_t, "tile_linearize_local"):
        return tile_linearize_local_plain(pts_pack, cell_t, xy0_t, xy1_t,
                                          mask_t, tables, loss, loss_scale,
                                          block_n, plane_dtype)
    return _cuda_linearize(pts_pack, cell_t, xy0_t, xy1_t, mask_t, tables,
                           loss, loss_scale, block_n, plane_dtype, bins)


@kernel_boundary
def tile_sweep_local(cell_t, jcam_t, jx_t, binv_t, gp_t, v_locals,
                     mode="matvec", block_n=256, bins=None, sorted_jcam=None):
    """Fused sweep over a locality-blocked bucket.

    ``cell_t`` carries LOCAL ids (W, Nb); ``v_locals`` the per-chunk local
    v tables (n_chunks, 18, V_local), i.e. ``v_cells[chunk_cells]``
    transposed. Modes: ``rhs`` = E^T B^-1 g_p, ``matvec`` = E^T B^-1 E v
    (per-chunk local bins (n_chunks, V_local, 18), which the caller sums
    into the global (V, 18), :func:`sum_chunk_bins`), ``edot`` = E v as
    (Nb, 3) rows. jcam/jx may be stored bf16; every sum is in binv's
    dtype. ``bins`` is the bucket's :func:`slot_bins` and ``sorted_jcam``
    its :func:`sort_jcam_planes` copy of ``jcam_t``, both read by the
    kernels in rhs/matvec (the plain version ignores them)."""
    if not _dispatch(binv_t, "tile_sweep_local"):
        return tile_sweep_local_plain(cell_t, jcam_t, jx_t, binv_t, gp_t,
                                      v_locals, mode, block_n)
    n_chunks, _, Vl = v_locals.shape
    v = v_locals.to(binv_t.dtype).contiguous()
    return _cuda_sweep(cell_t, jcam_t, jx_t, binv_t, gp_t, v, mode, block_n,
                       True, n_chunks, Vl, bins, tile_sweep_local, sorted_jcam)


@kernel_boundary
def tile_sweep(cell_t, jcam_t, jx_t, binv_t, gp_t, v_cells, mode="matvec",
               block_n=256, bins=None, sorted_jcam=None):
    """Fused bucket sweep against the global cell vector ``v_cells`` (V,
    18), for buckets without local tables. Returns (V, 18) for rhs/matvec,
    (Nb, 3) E v rows for edot; ``gp_t`` is read in rhs mode only and
    ``v_cells`` in matvec/edot only. ``bins`` as for
    :func:`tile_sweep_local`; ``sorted_jcam`` is the bucket's
    :func:`sort_jcam` copy of ``jcam_t``, which the kernels read in
    rhs/matvec (the plain version ignores both)."""
    if not _dispatch(binv_t, "tile_sweep"):
        return tile_sweep_plain(cell_t, jcam_t, jx_t, binv_t, gp_t, v_cells,
                                mode, block_n)
    V = v_cells.shape[0]
    out = _cuda_sweep(cell_t, jcam_t, jx_t, binv_t, gp_t, v_cells, mode,
                      block_n, False, 1, V, bins, tile_sweep, sorted_jcam)
    return out if mode == "edot" else out[0]


KERNEL_WRAPPERS = (tile_linearize_local, tile_sweep_local, tile_sweep)
# the helper kernels: the sweeps' sorted jcam copies, and the fixed-order
# row sums (a locality bucket's chunk bins and the step's other sums)
HELPERS = (sort_jcam, sort_jcam_planes, sum_rows)
for _fn in KERNEL_WRAPPERS + HELPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS + HELPERS:
        fn.launches = 0

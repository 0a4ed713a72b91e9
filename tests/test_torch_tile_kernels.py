"""Port parity: the tile kernels' plain versions against the JAX Pallas
kernels (interpret mode) and the JAX XLA sweeps.

The sweeps are the same sums in another order: rtol 1e-10, atol 1e-12 (the
tolerance of tests/test_tile_pallas.py). The fused linearize is held to the
tolerances of tests/test_tile_pallas.py:124-137,194-197 (cost rtol 1e-12,
system and planes rtol 1e-9). bf16 planes may differ by one bf16 rounding
step (a relative 2^-8) where the two f64 values straddle a rounding
boundary."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.io.synthetic import make_bal_synthetic, make_bal_tile_device
from deeparc_tpu.kernels import tile_pallas as jk
from deeparc_tpu.residuals.reprojection import camera_dim
from deeparc_tpu.residuals.reprojection import flatten_camera as jflatten
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver import tiles as jt
from deeparc_tpu.solver.linalg import inv3x3 as jinv3x3
from deeparc_tpu.solver.rig_grid import slot_params as jslot_params
from deeparc_tpu_torch.kernels import tile as tk
from deeparc_tpu_torch.kernels.rig_grid import _slot_products
from deeparc_tpu_torch.solver import tiles as tt
from deeparc_tpu_torch.solver.rig_grid import slot_params
from torch_parity import as_np, close, params_to_torch, tiles_to_torch

CHUNK = 64
T = lambda a: torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def sweep_problem():
    rig = make_bal_synthetic(n_cameras=10, n_points=90, track_length=5.0,
                             pixel_noise=0.5, point_noise=0.03, seed=9)
    scene = jfrom_deeparc(rig.data, dtype=jnp.float64)
    free = jfreeze(scene)
    tiles, params_t, free_t = jt.tiles_from_scene(scene, free,
                                                  chunk_obs=CHUNK)
    packed = jt.pack_cells(jslot_params(params_t, tiles.cells), tiles.cells,
                           jflatten(free))
    C = camera_dim(params_t)
    sys = jt.linearize_tiles(params_t.points, packed, tiles, free_t, C, CHUNK)
    binv = jinv3x3(sys.hpp + 0.1 * jnp.eye(3, dtype=jnp.float64))
    v = jnp.asarray(np.random.default_rng(0).normal(size=(C,)))
    return tiles, sys, binv, jt.flat_to_cells(v, tiles.cells.cols)


def _bucket_args(b, blk, binv, sys, offset, plane):
    Nb = b.cell.shape[0]
    cell_t, jcam_t, jx_t = jk.pack_bucket_planes(blk.j_x, blk.j_cam, plane)
    binv_t = binv[offset:offset + Nb].reshape(Nb, 9).T
    gp_t = sys.g_p[offset:offset + Nb].T
    return cell_t, jcam_t, jx_t, binv_t, gp_t


@pytest.mark.parametrize("mode", ["rhs", "matvec", "edot"])
def test_tile_sweep_plain_matches_jax(sweep_problem, mode):
    """Per bucket against JAX tile_sweep (interpret), and summed over the
    buckets against the XLA sweeps _e_sweep / _e_dot_cells."""
    tiles, sys, binv, v_cells = sweep_problem
    total, rows, offset = 0.0, [], 0
    for b, blk in zip(tiles.buckets, sys.blocks):
        args = _bucket_args(b, blk, binv, sys, offset, b.cell)
        want = jk.tile_sweep(*args, v_cells, mode=mode, block_n=128,
                             interpret=True)
        got = tk.tile_sweep(*(T(a) for a in args), T(v_cells), mode=mode)
        close(got, want, rtol=1e-10, atol=1e-12)
        if mode == "edot":
            rows.append(as_np(got))
        else:
            total = total + as_np(got)
        offset += b.cell.shape[0]
    if mode == "edot":
        tail = sys.g_p.shape[0] - offset
        got_all = np.concatenate(rows + [np.zeros((tail, 3))])
        want_all = jt._e_dot_cells(tiles, sys, v_cells, CHUNK)
    else:
        got_all = total
        want_all = jt._e_sweep(tiles, sys, binv,
                               None if mode == "rhs" else v_cells,
                               mode == "rhs", CHUNK)
    close(got_all, want_all, rtol=1e-10, atol=1e-12)


def _sorted_sweep(cell_t, jcam_t, jx_t, binv_t, gp_t, v_cells, mode, j_cam,
                  bins):
    """The data flow of tile_sweep's kernels in rhs/matvec, in torch: the
    cell-sorted jcam copy (``sort_jcam``), the row pass's per-slot
    t2 = jx . w scattered to each slot's sorted position (``SlotBins.pos``),
    and the bin pass's per-segment sums in list order, then each bin's
    segments in order."""
    W, Nb = cell_t.shape
    srt = tk.sort_jcam(j_cam, bins)
    jx = jx_t.reshape(W, 2, 3, Nb)
    if mode == "rhs":
        rhs = gp_t
    else:
        t = torch.einsum("wkjn,wnj->wkn", jcam_t.reshape(W, 2, 18, Nb),
                         v_cells[cell_t.long()])
        rhs = torch.einsum("wkin,wkn->in", jx, t)
    wv = torch.einsum("ijn,jn->in", binv_t.reshape(3, 3, Nb), rhs)
    t2 = torch.einsum("wkin,in->wnk", jx, wv).reshape(W * Nb, 2)
    t2_sorted = torch.empty_like(t2)
    t2_sorted[bins.pos.long()] = t2
    u = (srt.reshape(2, 18, -1) * t2_sorted.T[:, None, :]).sum(0)  # 18, S
    seg = bins.seg_start.long()
    partial = [u[:, s0:s1].sum(1) for s0, s1 in zip(seg[:-1], seg[1:])]
    bin_seg = bins.bin_seg.long()
    out = torch.zeros((bins.n_bins, 18), dtype=u.dtype)
    for i, (g0, g1) in enumerate(zip(bin_seg[:-1], bin_seg[1:])):
        for g in range(g0, g1):
            out[i] += partial[g]
    return out


@pytest.mark.parametrize("mode", ["rhs", "matvec"])
def test_sorted_sweep_data_flow_matches_plain_and_jax(sweep_problem, mode):
    """tile_sweep's kernel data flow (sorted jcam copy, t2 scattered to the
    sorted positions, segment sums in order) against tile_sweep_plain and
    JAX tile_sweep (interpret), per bucket, f64."""
    tiles, sys, binv, v_cells = sweep_problem
    V = v_cells.shape[0]
    offset = 0
    for b, blk in zip(tiles.buckets, sys.blocks):
        args = _bucket_args(b, blk, binv, sys, offset, b.cell)
        targs = tuple(T(a) for a in args)
        bins = tk.slot_bins(targs[0], 1, V)
        got = _sorted_sweep(*targs, T(v_cells), mode, T(blk.j_cam), bins)
        want = jk.tile_sweep(*args, v_cells, mode=mode, block_n=128,
                             interpret=True)
        close(got, want, rtol=1e-12, atol=1e-12)
        close(got, as_np(tk.tile_sweep_plain(*targs, T(v_cells), mode=mode)),
              rtol=1e-12, atol=1e-12)
        offset += b.cell.shape[0]


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_sort_jcam_gathers_the_sweep_planes(sweep_problem, dtype):
    """Column i of the sorted copy is slot order[i]'s column of the
    transposed jcam planes the row pass reads, bit for bit, also when both
    are stored in bf16."""
    tiles, sys, *_ = sweep_problem
    V = tiles.cells.cols.shape[0]
    for b, blk in zip(tiles.buckets, sys.blocks):
        cell_t, jcam_t, _ = tk.pack_bucket_planes(T(blk.j_x), T(blk.j_cam),
                                                  T(b.cell))
        W, Nb = cell_t.shape
        bins = tk.slot_bins(cell_t, 1, V)
        srt = tk.sort_jcam(T(blk.j_cam), bins, dtype)
        f = bins.order.long()
        planes = jcam_t if dtype is None else jcam_t.to(dtype)
        want = planes.reshape(W, 36, Nb)[f // Nb, :, f % Nb].T
        assert srt.dtype == planes.dtype
        assert torch.equal(srt, want)


@pytest.fixture(scope="module")
def fused_problem():
    # 2 chunks, W=4, V_local=8: multi-chunk binning and the local->global
    # scatter at the smallest shape (tests/test_tile_pallas.py:90-106)
    params, tiles, _, cam_free = make_bal_tile_device(
        n_cameras=24, n_points=128, track_length=3, window=8, chunk_obs=256,
        dtype=jnp.float64)
    packed = jt.pack_cells(jslot_params(params, tiles.cells), tiles.cells,
                           cam_free)
    params_p = params_to_torch(params)
    tiles_p = tiles_to_torch(tiles, cam_free.shape[0])
    packed_p = tt.pack_cells(slot_params(params_p, tiles_p.cells),
                             tiles_p.cells, T(cam_free))
    return params, tiles, packed, cam_free, params_p, tiles_p, packed_p


def _lin_inputs(points, b, packed, np_mod):
    """(pts_pack, local cell_t, xy0_t, xy1_t, mask_t, tables) of bucket b
    in either package (np_mod = jnp or torch)."""
    local, chunk_cells = b.loc
    Nb = b.cell.shape[0]
    if np_mod is torch:
        pts = torch.cat([points.T, torch.ones((3, Nb), dtype=points.dtype),
                         torch.zeros((2, Nb), dtype=points.dtype)])
        return (pts, local.T.contiguous(), b.xy0.T.contiguous(),
                b.xy1.T.contiguous(), b.mask.T.contiguous(),
                packed[chunk_cells.long()])
    pts = jnp.concatenate([points.T, jnp.ones((3, Nb)), jnp.zeros((2, Nb))])
    return (pts, local.T, b.xy0.T, b.xy1.T, b.mask.T, packed[chunk_cells])


@pytest.fixture(scope="module")
def jax_linearize(fused_problem):
    """JAX tile_linearize_local (interpret) of the fused problem's bucket,
    once per loss: the tests below hold two things against it."""
    params, tiles, packed = fused_problem[:3]
    memo = {}

    def run(loss, scale):
        if (loss, scale) not in memo:
            memo[loss, scale] = jk.tile_linearize_local(
                *_lin_inputs(params.points, tiles.buckets[0], packed, jnp),
                loss=loss, loss_scale=scale, interpret=True)
        return memo[loss, scale]

    return run


@pytest.mark.parametrize("loss,scale", [("trivial", 0.5), ("cauchy", 2.0)])
def test_tile_linearize_local_plain_matches_jax(fused_problem, jax_linearize,
                                                loss, scale):
    params, tiles, packed, _, params_p, tiles_p, packed_p = fused_problem
    close(packed_p, packed, rtol=1e-13, atol=1e-13)
    bp = tiles_p.buckets[0]
    want = jax_linearize(loss, scale)
    got = tk.tile_linearize_local(
        *_lin_inputs(params_p.points, bp, packed_p, torch), loss=loss,
        loss_scale=scale)
    close(got[0], want[0], rtol=1e-12)
    for g, w in zip(got[1:], want[1:]):
        close(g, w, rtol=1e-9, atol=1e-9)
        assert g.shape == w.shape


def test_tile_linearize_local_bf16_planes_match_jax(fused_problem):
    params, tiles, packed, _, params_p, tiles_p, packed_p = fused_problem
    want = jk.tile_linearize_local(
        *_lin_inputs(params.points, tiles.buckets[0], packed, jnp),
        interpret=True, plane_dtype=jnp.bfloat16)
    got = tk.tile_linearize_local(
        *_lin_inputs(params_p.points, tiles_p.buckets[0], packed_p, torch),
        plane_dtype=torch.bfloat16)
    close(got[0], want[0], rtol=1e-12)
    for i in (1, 5, 6):      # pout, gc, hc stay in the working dtype
        close(got[i], want[i], rtol=1e-9, atol=1e-9)
    for i in (2, 3, 4):      # r, jx, jcam planes
        assert got[i].dtype == torch.bfloat16
        w = np.asarray(want[i].astype(jnp.float32))
        np.testing.assert_allclose(got[i].float().numpy(), w, rtol=2 ** -7,
                                   atol=1e-30)


@pytest.mark.parametrize("mode", ["rhs", "matvec", "edot"])
def test_tile_sweep_local_plain_matches_jax(fused_problem, mode):
    params, tiles, packed, cam_free, *_ = fused_problem
    C = camera_dim(params)
    pf = jnp.ones_like(params.points)
    sys = jt.linearize_tiles(params.points, packed, tiles, pf, C)
    binv = jinv3x3(sys.hpp + 0.1 * jnp.eye(3, dtype=jnp.float64))
    v_cells = jt.flat_to_cells(
        jnp.asarray(np.random.default_rng(1).normal(size=(C,))),
        tiles.cells.cols)
    b, blk = tiles.buckets[0], sys.blocks[0]
    cc = b.loc[1]
    v_loc = (jnp.zeros((cc.shape[0], 18, cc.shape[1])) if mode == "rhs"
             else jnp.swapaxes(v_cells[cc], 1, 2))
    args = _bucket_args(b, blk, binv, sys, 0, b.loc[0])
    want = jk.tile_sweep_local(*args, v_loc, mode=mode, block_n=128,
                               interpret=True)
    got = tk.tile_sweep_local(*(T(a) for a in args), T(v_loc), mode=mode)
    assert tuple(got.shape) == want.shape
    close(got, want, rtol=1e-10, atol=1e-12)


def _local_problem(fused_problem, mode):
    """tile_sweep_local's JAX inputs and (W, Nb) local plane of the fused
    problem's bucket (2 chunks, V_local 8), as in the test above."""
    params, tiles, packed, cam_free, *_ = fused_problem
    C = camera_dim(params)
    sys = jt.linearize_tiles(params.points, packed, tiles,
                             jnp.ones_like(params.points), C)
    binv = jinv3x3(sys.hpp + 0.1 * jnp.eye(3, dtype=jnp.float64))
    v_cells = jt.flat_to_cells(
        jnp.asarray(np.random.default_rng(1).normal(size=(C,))),
        tiles.cells.cols)
    b, blk = tiles.buckets[0], sys.blocks[0]
    cc = b.loc[1]
    v_loc = (jnp.zeros((cc.shape[0], 18, cc.shape[1])) if mode == "rhs"
             else jnp.swapaxes(v_cells[cc], 1, 2))
    return _bucket_args(b, blk, binv, sys, 0, b.loc[0]), v_loc


def _local_sorted_sweep(cell_t, jcam_t, jx_t, binv_t, gp_t, v_loc, mode,
                        bins, n_chunks):
    """The data flow of tile_sweep_local's kernels in rhs/matvec, in torch:
    the chunk-sorted copy of the jcam planes (``sort_jcam_planes``), each
    slot's t2 = jx . w at its sorted position (``SlotBins.pos``), and each
    chunk's bins summed over their runs of sorted positions in order."""
    W, Nb = cell_t.shape
    Vl = v_loc.shape[2]
    srt = tk.sort_jcam_planes(jcam_t, bins, n_chunks)
    jx = jx_t.reshape(W, 2, 3, Nb)
    if mode == "rhs":
        rhs = gp_t
    else:
        chunk = torch.arange(Nb) // (Nb // n_chunks)
        vv = v_loc[chunk[None, :], :, cell_t.long()]             # W, Nb, 18
        t = torch.einsum("wkjn,wnj->wkn", jcam_t.reshape(W, 2, 18, Nb), vv)
        rhs = torch.einsum("wkin,wkn->in", jx, t)
    wv = torch.einsum("ijn,jn->in", binv_t.reshape(3, 3, Nb), rhs)
    t2 = torch.einsum("wkin,in->wnk", jx, wv).reshape(W * Nb, 2)
    t2_sorted = torch.empty_like(t2)
    t2_sorted[bins.pos.long()] = t2
    u = (srt.reshape(2, 18, -1) * t2_sorted.T[:, None, :]).sum(0)  # 18, S
    bstart = bins.seg_start.long()[bins.bin_seg.long()]
    out = torch.stack([u[:, s0:s1].sum(1)
                       for s0, s1 in zip(bstart[:-1], bstart[1:])])
    return out.reshape(n_chunks, Vl, 18)


@pytest.mark.parametrize("mode", ["rhs", "matvec"])
def test_local_sweep_data_flow_matches_plain_and_jax(fused_problem, mode):
    """tile_sweep_local's kernel data flow (chunk-sorted plane copy, t2 at
    the sorted positions, per-chunk bins in position order) against
    tile_sweep_local_plain and JAX tile_sweep_local (interpret), and its
    fixed-order sum into the global cells (the bins' ``gather`` map)
    against index_add_ of JAX's bins, f64."""
    args, v_loc = _local_problem(fused_problem, mode)
    tiles_p = fused_problem[5]
    b = tiles_p.buckets[0]
    n_chunks, Vl = b.loc[1].shape
    V = tiles_p.cells.cols.shape[0]
    targs = tuple(T(a) for a in args)
    bins = tk.slot_bins(targs[0].contiguous(), n_chunks, Vl)
    bins = bins._replace(gather=tk.chunk_gather(bins, b.loc[1], V))
    got = _local_sorted_sweep(*targs, T(v_loc), mode, bins, n_chunks)
    want = jk.tile_sweep_local(*args, v_loc, mode=mode, block_n=128,
                               interpret=True)
    close(got, want, rtol=1e-12, atol=1e-12)
    close(got, as_np(tk.tile_sweep_local_plain(*targs, T(v_loc), mode=mode)),
          rtol=1e-12, atol=1e-12)
    cstart, src = (t.long() for t in bins.gather)
    flat = got.reshape(-1, 18)
    cells = torch.stack([flat[src[c0:c1]].sum(0) if c1 > c0 else
                         torch.zeros(18, dtype=flat.dtype)
                         for c0, c1 in zip(cstart[:-1], cstart[1:])])
    want_cells = np.zeros((V, 18))
    np.add.at(want_cells, np.asarray(b.loc[1]).reshape(-1),
              np.asarray(want).reshape(-1, 18))
    close(cells, want_cells, rtol=1e-12, atol=1e-12)
    close(tk.sum_chunk_bins(got, b.loc[1], V, bins), want_cells, rtol=1e-12,
          atol=1e-12)


def _run_linearize_bins(pts, cell_t, xy0_t, xy1_t, mask_t, tables, bins,
                        loss, scale):
    """The data flow of tile_linearize_local's bin pass, in torch: one run
    of bins (``SlotBins.runs``) at a time, every slot recomputed in the
    working dtype at its sorted position (``order``), and each bin's 189
    values summed over its slots in slot order into its row."""
    W, Nb = cell_t.shape
    n_chunks, Vl, _ = tables.shape
    f = bins.order.long()
    p = f % Nb
    tb = tables[p // (Nb // n_chunks), cell_t.reshape(-1)[f].long()]
    col = lambda c: tb[:, tk._TILE_COL[c]]
    X = [pts[a, p] for a in range(3)]
    pf = [pts[3 + a, p] for a in range(3)]
    _, r0, r1, _, P = _slot_products(
        col, X, pf, xy0_t.reshape(-1)[f], xy1_t.reshape(-1)[f],
        mask_t.reshape(-1)[f], loss, scale, zguard=True)
    P0, P1 = torch.stack(P[0]), torch.stack(P[1])                  # 18, S
    iu, ju = torch.triu_indices(18, 18)
    vals = torch.cat([P0 * r0 + P1 * r1,
                      P0[iu] * P0[ju] + P1[iu] * P1[ju]]).T         # S, 189
    bstart = bins.seg_start.long()[bins.bin_seg.long()]
    out = torch.zeros((bins.n_bins, 189), dtype=vals.dtype)
    runs = bins.runs.long()
    for b0, b1 in zip(runs[:-1].tolist(), runs[1:].tolist()):
        assert b0 // Vl == (b1 - 1) // Vl        # one chunk's bins
        for b in range(b0, b1):
            s0, s1 = int(bstart[b]), int(bstart[b + 1])
            if s1 > s0:                          # a running sum: slot order
                out[b] = vals[s0:s1].cumsum(0)[-1]
    return (out[:, :18].reshape(n_chunks, Vl, 18),
            out[:, 18:].reshape(n_chunks, Vl, 171))


@pytest.mark.parametrize("loss,scale", [("trivial", 0.5), ("cauchy", 2.0)])
def test_linearize_bins_data_flow_matches_plain_and_jax(
        fused_problem, jax_linearize, loss, scale):
    """tile_linearize_local's bin pass data flow (one block per run of
    bins, slots recomputed through the sorted list, each bin summed in
    slot order) against tile_linearize_local_plain and JAX
    tile_linearize_local (interpret), f64."""
    params_p, tiles_p, packed_p = fused_problem[4:]
    args = _lin_inputs(params_p.points, tiles_p.buckets[0], packed_p, torch)
    n_chunks, Vl, _ = args[5].shape
    bins = tk.slot_bins(args[1], n_chunks, Vl)
    gc, hc = _run_linearize_bins(*args, bins, loss, scale)
    want = jax_linearize(loss, scale)
    plain = tk.tile_linearize_local_plain(*args, loss=loss, loss_scale=scale)
    for got, w, pl in ((gc, want[5], plain[5]), (hc, want[6], plain[6])):
        close(got, w, rtol=1e-10, atol=1e-10)
        close(got, as_np(pl), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("local,run_slots,run_bins", [
    (True, 8192, 1024), (True, 8, 3), (False, 8192, 1024), (False, 16, 5)])
def test_bin_runs_sum_like_index_add(fused_problem, monkeypatch, local,
                                     run_slots, run_bins):
    """SlotBins.runs cuts the bins into runs in bin order, each inside one
    chunk (one run a chunk when the chunk fits), of at most RUN_BINS bins,
    every bin but a run's first starting within RUN_SLOTS sorted slots of
    the run's first; summing each run's bins over their sorted slots
    equals index_add_ over the bins."""
    monkeypatch.setattr(tk, "RUN_SLOTS", run_slots)
    monkeypatch.setattr(tk, "RUN_BINS", run_bins)
    tiles_p = fused_problem[5]
    b = tiles_p.buckets[0]
    if local:
        cell_t, (n_chunks, n_cells) = b.loc[0].T, b.loc[1].shape
    else:
        cell_t, n_chunks, n_cells = b.cell.T, 1, tiles_p.cells.cols.shape[0]
    bins = tk.slot_bins(cell_t.contiguous(), n_chunks, n_cells)
    runs = bins.runs.long()
    assert bins.runs.dtype == torch.int32
    assert runs[0] == 0 and runs[-1] == bins.n_bins
    assert bool((runs[1:] > runs[:-1]).all())
    assert int((runs[1:] - runs[:-1]).max()) <= run_bins
    bstart = bins.seg_start.long()[bins.bin_seg.long()]
    W, Nb = cell_t.shape
    if W * Nb // n_chunks <= run_slots and n_cells <= run_bins:
        assert runs.numel() - 1 == n_chunks      # one run a chunk
    order = bins.order.long()
    key = ((torch.arange(Nb) // (Nb // n_chunks))[None, :] * n_cells
           + cell_t.long()).reshape(-1)
    vals = torch.randn(W * Nb, 7, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(2))
    out = torch.zeros((bins.n_bins, 7), dtype=torch.float64)
    for b0, b1 in zip(runs[:-1].tolist(), runs[1:].tolist()):
        assert b0 // n_cells == (b1 - 1) // n_cells
        assert int(bstart[b1 - 1] - bstart[b0]) < run_slots or b1 - b0 == 1
        for bb in range(b0, b1):
            s0, s1 = int(bstart[bb]), int(bstart[bb + 1])
            assert bool((key[order[s0:s1]] == bb).all())
            out[bb] = vals[order[s0:s1]].sum(0)
    want = torch.zeros(bins.n_bins, 7, dtype=torch.float64).index_add_(
        0, key, vals)
    close(out, want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_sort_jcam_planes_gathers_the_sweep_planes(fused_problem, dtype):
    """Column i of the chunk-sorted copy is slot order[i]'s column of the
    transposed jcam planes the row pass reads, bit for bit, also when they
    are stored in bf16; a chunk's sorted positions read only its rows."""
    args, _ = _local_problem(fused_problem, "matvec")
    cell_t, jcam_t = T(args[0]).contiguous(), T(args[1])
    if dtype is not None:
        jcam_t = jcam_t.to(dtype)
    n_chunks, Vl = fused_problem[5].buckets[0].loc[1].shape
    W, Nb = cell_t.shape
    bins = tk.slot_bins(cell_t, n_chunks, Vl)
    srt = tk.sort_jcam_planes(jcam_t, bins, n_chunks)
    assert srt.dtype == jcam_t.dtype and srt.shape == (36, W * Nb)
    for i, f in enumerate(bins.order.tolist()):
        w, p = divmod(f, Nb)
        assert torch.equal(srt[:, i], jcam_t[36 * w:36 * w + 36, p])
        assert p // (Nb // n_chunks) == i // (W * Nb // n_chunks)


@pytest.mark.parametrize("F", [18, 171])
def test_chunk_gather_sums_like_index_add(fused_problem, F):
    """The layout's chunk -> cell map lists each cell's non-empty bins in
    increasing bin order, and summing through it equals index_add_ over
    chunk_cells (sum_chunk_bins's plain version), for the sweeps' and the
    linearize's gradient bins (F = 18) and the linearize's Gram bins
    (F = 171)."""
    tiles_p = fused_problem[5]
    b = tiles_p.buckets[0]
    V = tiles_p.cells.cols.shape[0]
    chunk_cells = b.loc[1]
    cstart, src = (t.long() for t in b.bins.gather)
    assert b.bins.gather[0].dtype == torch.int32 and cstart[-1] == src.numel()
    nonempty = b.bins.bin_seg[1:] > b.bins.bin_seg[:-1]
    assert torch.equal(torch.sort(src).values, nonempty.nonzero()[:, 0])
    flat_cells = chunk_cells.reshape(-1).long()
    for v, (c0, c1) in enumerate(zip(cstart[:-1], cstart[1:])):
        assert bool((flat_cells[src[c0:c1]] == v).all())
        assert bool((src[c0 + 1:c1] > src[c0:c1 - 1]).all())
    part = torch.randn(chunk_cells.shape + (F,), dtype=torch.float64,
                       generator=torch.Generator().manual_seed(2))
    part.reshape(-1, F)[~nonempty] = 0.0
    want = tk.sum_chunk_bins(part, chunk_cells, V, b.bins)
    assert want.shape == (V, F)
    got = _gather_like_kernel(part.reshape(-1, F), b.bins.gather)
    close(got, as_np(want), rtol=1e-14, atol=1e-14)


def _gather_like_kernel(part, gather):
    """A torch mirror of the card's gather kernel (csrc/tile.cu,
    ``gather_cells``): per output row, stripes of every 8th source (every
    32nd for rows of one value), each summed in list order, then the
    stripes added in order; a map that cuts long rows into segments sums
    the segments first, then each row's segments by a second pass."""
    if len(gather) == 4:
        part = _gather_like_kernel(part, gather[:2])
        gather = gather[2:]
    cstart, src = (t.long() for t in gather)
    F = part.shape[1]
    gs = 32 if F == 1 else 8
    rows = []
    for c0, c1 in zip(cstart[:-1].tolist(), cstart[1:].tolist()):
        stripes = []
        for st in range(gs):
            acc = torch.zeros(F, dtype=part.dtype)
            for k in range(c0 + st, c1, gs):
                acc = acc + part[src[k]]
            stripes.append(acc)
        total = stripes[0]
        for t in stripes[1:]:
            total = total + t
        rows.append(total)
    return torch.stack(rows)


@pytest.mark.parametrize("which", ["flat", "block6"])
def test_cell_maps_sum_like_index_add(fused_problem, which):
    """The step's two cell -> camera sums: ``cells_to_flat`` and the
    block-Jacobi's 6x6 blocks. Their fixed-order maps (built once per
    layout, ``CellTable.maps``) list each output's sources in increasing
    order; summed in the card's order they equal the index_add_ results,
    and repeated calls give identical bits. On the CPU the solver's own
    functions equal the former index_add_ code bit for bit."""
    params_p, tiles_p = fused_problem[4], fused_problem[5]
    cells = tiles_p.cells
    V = cells.cols.shape[0]
    C = 6 * params_p.ext_rot.shape[0] + 6 * params_p.center.shape[0]
    gen = torch.Generator().manual_seed(5)
    if which == "flat":
        dst = cells.cols.reshape(-1).long()
        part = torch.randn((V * 18, 1), dtype=torch.float64, generator=gen)
        n_out = C
        gather = cells.maps[0]
    else:
        dst = torch.cat([cells.cols[:, j] // 6 for j in (0, 6, 12)]).long()
        part = torch.randn((3 * V, 36), dtype=torch.float64, generator=gen)
        n_out = C // 6
        gather = cells.maps[1]
    cstart, src = (t.long() for t in gather)
    assert gather[0].dtype == torch.int32 and cstart[-1] == dst.numel()
    assert cstart.numel() == n_out + 1
    for o, (c0, c1) in enumerate(zip(cstart[:-1], cstart[1:])):
        assert bool((dst[src[c0:c1]] == o).all())
        assert bool((src[c0 + 1:c1] > src[c0:c1 - 1]).all())
    want = torch.zeros((n_out, part.shape[1]), dtype=torch.float64)
    want.index_add_(0, dst, part)
    got = _gather_like_kernel(part, gather)
    assert torch.equal(got, _gather_like_kernel(part, gather))
    close(got, as_np(want), rtol=1e-14, atol=1e-14)
    if which == "flat":
        vals = part.reshape(V, 18)
        old = torch.zeros(C, dtype=vals.dtype).index_add_(
            0, cells.cols.reshape(-1).long(), vals.reshape(-1))
        assert torch.equal(tt.cells_to_flat(vals, cells, C), old)
        return
    h = torch.randn((V, 18, 18), dtype=torch.float64, generator=gen)
    hcc = h @ h.transpose(1, 2)
    sys_ = tt.TileSystem(cost=None, g_p=None, hpp=None, g_c=None,
                         hcc_cells=hcc, hcc_diag=None, blocks=())
    cam_aug = torch.rand(C, dtype=torch.float64, generator=gen) + 1.0
    cam_free = torch.ones(C, dtype=torch.float64)
    old = torch.zeros((C // 6, 6, 6), dtype=torch.float64)
    for j, sl in ((0, slice(0, 6)), (6, slice(6, 12)), (12, slice(12, 18))):
        old.index_add_(0, (cells.cols[:, j] // 6).long(), hcc[:, sl, sl])
    old = old + torch.eye(6, dtype=torch.float64) * cam_aug.reshape(-1, 6)[
        :, :, None]
    v = torch.randn(C, dtype=torch.float64, generator=gen)
    want_v = torch.einsum("bij,bj->bi", torch.linalg.inv(old),
                          v.reshape(-1, 6)).reshape(-1)
    precond = tt._block_jacobi(sys_, cells, cam_aug, cam_free, C)
    assert torch.equal(precond(v), want_v)
    assert torch.equal(precond(v), precond(v))


def test_piece_maps_sum_the_chunk_path_like_index_add(fused_problem,
                                                     monkeypatch):
    """Every bucket carries one fixed-order map per row piece of the torch
    chunk path (which the step takes for buckets without local tables or
    too wide for the fused linearize), which leaves out the masked slots;
    its slot rows (zero where masked, as the step's are) summed through
    them in the card's order equal index_add_ over the piece's global
    cells."""
    tiles_p = fused_problem[5]
    V = tiles_p.cells.cols.shape[0]
    b = tiles_p.buckets[0]
    assert len(b.pieces) == len(list(tt._row_pieces(*b.cell.shape)))
    monkeypatch.setattr(tt, "_PIECE_SLOTS", 64)
    b = tt.with_bins(b._replace(loc=(), bins=()), V)
    Nb, W = b.cell.shape
    pieces = list(tt._row_pieces(Nb, W))
    assert len(pieces) > 1 and len(b.pieces) == len(pieces)
    gen = torch.Generator().manual_seed(7)
    masked = 0
    for (r0, r1), gather in zip(pieces, b.pieces):
        cell = b.cell[r0:r1].reshape(-1).long()
        live = b.mask[r0:r1].reshape(-1) > 0.5
        masked += int((~live).sum())
        assert torch.equal(torch.sort(gather[1].long()).values,
                           live.nonzero()[:, 0])
        part = torch.randn((cell.numel(), 171), dtype=torch.float64,
                           generator=gen) * live[:, None]
        want = torch.zeros((V, 171), dtype=torch.float64)
        want.index_add_(0, cell, part)
        close(_gather_like_kernel(part, gather), as_np(want), rtol=1e-14,
              atol=1e-14)
        assert torch.equal(tk.sum_rows(part, cell, V, gather), want)
    assert masked > 0


@pytest.mark.parametrize("max_len", [1, 3, 40])
def test_split_gather_map_sums_like_index_add(max_len):
    """A map that cuts rows of more than ``max_len`` sources into segments
    (a hub cell's slots in a piece of the torch chunk path): every segment
    holds at most max_len of its row's sources, in list order, each row's
    segments are consecutive, and the two passes in the card's order equal
    index_add_; a map whose rows all fit keeps one pass."""
    gen = torch.Generator().manual_seed(11)
    n_out = 9
    dst = torch.randint(-1, n_out, (300,), generator=gen)
    dst[:120] = 4                                     # one long row
    dst[dst == 7] = 6                                 # row 7 empty
    part = torch.randn((dst.numel(), 18), dtype=torch.float64, generator=gen)
    whole = tk.gather_map(dst, n_out)
    gather = tk.gather_map(dst, n_out, max_len)
    assert len(whole) == 2 and len(gather) == 4
    assert torch.equal(gather[1], whole[1])
    seg_cs, seg_start = gather[0].long(), gather[2].long()
    assert torch.equal(gather[3].long(), torch.arange(seg_cs.numel() - 1))
    for o in range(n_out):
        s0, s1 = int(seg_start[o]), int(seg_start[o + 1])
        assert int(seg_cs[s0]) == int(whole[0][o])
        assert int(seg_cs[s1]) == int(whole[0][o + 1])
        lens = seg_cs[s0 + 1:s1 + 1] - seg_cs[s0:s1]
        assert bool((lens > 0).all()) and bool((lens <= max_len).all())
    want = torch.zeros((n_out, 18), dtype=torch.float64)
    keep = dst >= 0
    want.index_add_(0, dst[keep], part[keep])
    close(_gather_like_kernel(part, gather), as_np(want), rtol=1e-14,
          atol=1e-14)
    longest = int(torch.bincount(dst[keep]).max())
    assert len(tk.gather_map(dst, n_out, longest)) == 2


@pytest.mark.parametrize("local", [True, False])
def test_slot_bins_reduce_like_index_add(fused_problem, local):
    """The kernels' bin structure, emulated with torch: every slot in
    exactly one segment, segments inside one bin and at most SEGMENT long,
    and the segment-then-bin sums equal index_add_ over the bins."""
    tiles_p = fused_problem[5]
    b = tiles_p.buckets[0]
    if local:
        cell_t = b.loc[0].T
        n_chunks, n_cells = b.loc[1].shape
    else:
        cell_t, n_chunks, n_cells = b.cell.T, 1, tiles_p.cells.cols.shape[0]
    bins = tk.slot_bins(cell_t.contiguous(), n_chunks, n_cells)
    W, Nb = cell_t.shape
    order = bins.order.long()
    assert torch.equal(torch.sort(order).values, torch.arange(W * Nb))
    seg = bins.seg_start.long()
    assert int((seg[1:] - seg[:-1]).max()) <= tk.SEGMENT
    key = ((torch.arange(Nb) // (Nb // n_chunks))[None, :] * n_cells
           + cell_t.long()).reshape(-1)
    vals = torch.randn(W * Nb, 5, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(0))
    partial = torch.stack([vals[order[s0:s1]].sum(0)
                           for s0, s1 in zip(seg[:-1], seg[1:])])
    bin_seg = bins.bin_seg.long()
    out = torch.stack([partial[g0:g1].sum(0)
                       for g0, g1 in zip(bin_seg[:-1], bin_seg[1:])])
    for s0, s1 in zip(seg[:-1], seg[1:]):
        assert key[order[s0:s1]].unique().numel() == 1
    want = torch.zeros(bins.n_bins, 5, dtype=torch.float64).index_add_(
        0, key, vals)
    close(out, want.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("local", [True, False])
def test_slot_bins_pos_inverts_order(fused_problem, local):
    """SlotBins.pos is the inverse of order: the sorted position of each
    flat slot id, where tile_sweep's row pass writes the slot's t2."""
    tiles_p = fused_problem[5]
    b = tiles_p.buckets[0]
    if local:
        cell_t, (n_chunks, n_cells) = b.loc[0].T, b.loc[1].shape
    else:
        cell_t, n_chunks, n_cells = b.cell.T, 1, tiles_p.cells.cols.shape[0]
    bins = tk.slot_bins(cell_t.contiguous(), n_chunks, n_cells)
    order, pos = bins.order.long(), bins.pos.long()
    n = order.numel()
    assert bins.pos.dtype == torch.int32 and pos.numel() == n
    assert torch.equal(pos[order], torch.arange(n))
    assert torch.equal(order[pos], torch.arange(n))


def test_layout_bins_fit_and_are_required(fused_problem):
    """The layout carries each bucket's bins (the card path never builds
    them): they fit the bucket's plane, and missing or mismatched bins are
    refused before a launch."""
    b = fused_problem[5].buckets[0]
    W, Nb = b.loc[0].T.shape
    n_bins = b.loc[1].numel()
    assert tk._check_bins(b.bins, W, Nb, n_bins, b.cell.device) is b.bins
    for bins, nb in ((None, n_bins), ((), n_bins), (b.bins, n_bins + 1)):
        with pytest.raises(ValueError):
            tk._check_bins(bins, W, Nb, nb, b.cell.device)


def test_linearize_tiles_chunk_path_matches_fused_and_jax(fused_problem):
    """The torch chunk path (``linearize_tiles``, which the step takes for
    wide or unblocked buckets) against JAX ``linearize_tiles``, and the
    mixed linearize's fused-kernel planes against the chunk path's blocks
    (tests/test_tile_pallas.py:109-137, tolerances as there)."""
    params, tiles, packed, _, params_p, tiles_p, packed_p = fused_problem
    C = camera_dim(params)
    pf = torch.ones_like(params_p.points)
    want = jt.linearize_tiles(params.points, packed, tiles,
                              jnp.ones_like(params.points), C)
    ref = tt.linearize_tiles(params_p.points, packed_p, tiles_p, pf, C)
    sys_f, planes = tt.linearize_tiles_mixed(params_p.points, packed_p,
                                             tiles_p, pf, C)
    assert tt.bucket_fused_ok(tiles_p.buckets[0])
    close(ref.cost, want.cost, rtol=1e-12)
    close(sys_f.cost, want.cost, rtol=1e-12)
    for f in ("g_p", "hpp", "g_c", "hcc_cells", "hcc_diag"):
        close(getattr(ref, f), getattr(want, f), rtol=1e-9, atol=1e-9)
        close(getattr(sys_f, f), getattr(want, f), rtol=1e-9, atol=1e-9)
    b, blk = tiles_p.buckets[0], ref.blocks[0]
    cell_t, jcam_t, jx_t = tk.pack_bucket_planes(blk.j_x, blk.j_cam, b.loc[0])
    assert torch.equal(planes[0][0], cell_t)
    close(planes[0][1], as_np(jcam_t), rtol=1e-9, atol=1e-12)
    close(planes[0][2], as_np(jx_t), rtol=1e-9, atol=1e-12)
    close(planes[0][3], as_np(blk.r.permute(1, 2, 0).reshape(-1, b.cell.shape[0])),
          rtol=1e-9, atol=1e-12)

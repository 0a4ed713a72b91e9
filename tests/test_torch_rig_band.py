"""Port parity: live-band prep and grid densification (PyTorch port vs JAX).

The band tables (starts, width groups, cell order) must be IDENTICAL. The
point order is identical up to points whose circular-mean angles agree
to 1e-12: such points tie in exact arithmetic, and the two packages' matmuls
break the tie in different last bits."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.io import make_hemisphere_rig
from deeparc_tpu.io.synthetic import make_grid_rig_device
from deeparc_tpu.kernels import rig_pallas as jk
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver import rig_band as jrb
from deeparc_tpu.solver.rig_band import band_grid as jband_grid
from deeparc_tpu.solver.rig_grid import grid_from_scene as jgrid_from_scene
from deeparc_tpu_torch.io.synthetic import make_grid_rig_device as tmake_grid
from deeparc_tpu_torch.kernels import rig_grid as tk
from deeparc_tpu_torch.scene import from_deeparc
from deeparc_tpu_torch.solver.rig_band import (
    _cell_orderings,
    _covers_from_liveness,
    _group_tiles,
    _partition_sequence,
    _partition_widths,
    _point_order,
    band_grid,
    band_grid_update,
    point_angles,
)
from deeparc_tpu_torch.solver.rig_grid import grid_from_scene
from torch_parity import as_np, grid_to_torch


@pytest.fixture(scope="module")
def occlusion():
    rig = make_hemisphere_rig(n_arc=3, n_ring=16, n_points=420,
                              occlusion_rings=4, visibility=0.9,
                              pixel_noise=0.8, point_noise=0.02, seed=5)
    return rig.data, jgrid_from_scene(jfrom_deeparc(rig.data))


def test_grid_from_scene_matches_jax(occlusion):
    data, jgrid = occlusion
    grid = grid_from_scene(from_deeparc(data, device="cpu"))
    for k, v in jgrid._asdict().items():
        if k != "band":
            np.testing.assert_array_equal(as_np(getattr(grid, k)),
                                          np.asarray(v), err_msg=k)


def test_grid_from_scene_scatters_live_only_and_rejects_duplicates(occlusion):
    data, _ = occlusion
    scene = from_deeparc(data, device="cpu")
    # a dead duplicate of a live observation must not reach the grid
    dup = dataclasses.replace(
        scene.index,
        **{f: torch.cat([getattr(scene.index, f), getattr(scene.index, f)[:1]])
           for f in ("obs_point", "obs_outer", "obs_inner", "obs_intr",
                     "obs_xy", "obs_mask")})
    dup.obs_xy[-1] += 100.0
    dup.obs_mask[-1] = 0.0
    meta = dataclasses.replace(
        scene.meta, obs_arc=np.append(scene.meta.obs_arc, scene.meta.obs_arc[0]),
        obs_ring=np.append(scene.meta.obs_ring, scene.meta.obs_ring[0]))
    g0 = grid_from_scene(scene)
    g1 = grid_from_scene(dataclasses.replace(scene, index=dup, meta=meta))
    assert torch.equal(g0.xy0, g1.xy0) and torch.equal(g0.mask, g1.mask)
    # two LIVE observations on one (point, cell) pair have no defined winner
    dup.obs_mask[-1] = 1.0
    with pytest.raises(ValueError, match="share one"):
        grid_from_scene(dataclasses.replace(scene, index=dup, meta=meta))


@pytest.mark.parametrize("block_np,cost_block_np", [(64, 128), (256, 1024)])
def test_band_grid_matches_jax(occlusion, block_np, cost_block_np):
    _, jgrid = occlusion
    want = jband_grid(jgrid, block_np=block_np, cost_block_np=cost_block_np)
    tgrid = grid_to_torch(jgrid)
    got = band_grid(tgrid, block_np=block_np, cost_block_np=cost_block_np)
    assert want is not None and got is not None
    assert got.lin_groups == want.lin_groups
    assert got.cost_groups == want.cost_groups
    assert (got.w_band, got.w_band_cost) == (want.w_band, want.w_band_cost)
    np.testing.assert_array_equal(as_np(got.cell_perm),
                                  np.asarray(want.cell_perm))
    for a, b in zip(got.grid.band[:2], want.grid.band[:2]):
        np.testing.assert_array_equal(as_np(a), np.asarray(b))
    # same point order, up to exact-arithmetic ties of the sort key
    theta = as_np(point_angles(tgrid.mask, got.cell_perm))
    perm_t, perm_j = as_np(got.perm), np.asarray(want.perm)
    np.testing.assert_allclose(theta[perm_t], theta[perm_j], rtol=0,
                               atol=1e-12)
    differ = perm_t != perm_j
    assert differ.sum() <= 0.02 * perm_t.size, differ.sum()
    np.testing.assert_array_equal(np.sort(perm_t), np.arange(perm_t.size))


def _runs(rng, n, nb, lengths):
    """n liveness rows, each one cyclic run of live slabs, of a length
    drawn from ``lengths``, at a random start."""
    at = (rng.integers(0, nb, n)[:, None] + np.arange(nb)) % nb
    lv = np.zeros((n, nb), bool)
    lv[np.arange(n)[:, None], at] = (np.arange(nb)
                                     < rng.choice(lengths, n)[:, None])
    return lv


def _empty_rows(rng):
    lv = rng.random((120, 24)) < 0.2
    lv[::3] = False
    return lv


def _wrap_around(rng):
    lv = rng.random((120, 24)) < 0.1
    lv[:, [0, 23]] = True
    return lv


# name -> (liveness from a generator, max_groups); "cell" shapes are the
# rig-occl.solve cell's: 1,563 tiles of 256 points and 391 of 1024, 24 slabs
HELPER_CASES = {
    "cell-lin-runs": (lambda r: _runs(r, 1563, 24, np.arange(1, 25)), 4),
    "cell-cost-runs": (lambda r: _runs(r, 391, 24, np.arange(1, 25)), 3),
    "cell-lin-scattered": (lambda r: r.random((1563, 24)) < 0.15, 4),
    "equal-covers": (lambda r: _runs(r, 200, 24, [5]), 4),
    "two-valued-covers": (lambda r: _runs(r, 300, 24, [3, 9]), 3),
    "single-tile": (lambda r: _runs(r, 1, 24, [6]), 4),
    "no-tiles": (lambda r: np.zeros((0, 24), bool), 4),
    "empty-rows": (_empty_rows, 4),
    "wrap-around": (_wrap_around, 4),
    "all-live": (lambda r: np.ones((40, 24), bool), 4),
    **{f"groups-{g}": (lambda r: _runs(r, 257, 16, np.arange(1, 17)), g)
       for g in (1, 2, 3, 4)},
}


@pytest.mark.parametrize("case", list(HELPER_CASES))
def test_band_helpers_match_reference(case):
    """The port's array forms of the tile covers and the width partitions
    give what the reference's loops of the same name give, ties
    included."""
    make, max_groups = HELPER_CASES[case]
    lv = make(np.random.default_rng(0))
    nb = lv.shape[1]
    want_starts, want_covers = jrb._covers_from_liveness(lv)
    got_starts, got_covers = _covers_from_liveness(torch.as_tensor(lv))
    assert got_starts.dtype == got_covers.dtype == torch.int32
    np.testing.assert_array_equal(as_np(got_starts), want_starts)
    np.testing.assert_array_equal(as_np(got_covers), want_covers)
    covers = torch.as_tensor(want_covers)
    if covers.numel():
        np.testing.assert_array_equal(
            as_np(_partition_widths(covers, max_groups)),
            jrb._partition_widths(want_covers, max_groups))
    else:
        # the reference's partition has no answer for no tiles: both refuse
        with pytest.raises(IndexError):
            jrb._partition_widths(want_covers, max_groups)
        with pytest.raises(IndexError):
            _partition_widths(covers, max_groups)
    got_order, got_groups = _group_tiles(covers, max_groups)
    want_order, want_groups = jrb._group_tiles(want_covers, max_groups)
    np.testing.assert_array_equal(as_np(got_order), want_order)
    assert got_groups == want_groups
    assert (_partition_sequence(covers, max_groups, 8 * nb)
            == jrb._partition_sequence(want_covers, max_groups, 8 * nb))


def _loop_band_tables(grid, block_np, cost_block_np, max_groups=4,
                      max_groups_cost=3):
    """The band tables as the loop forms build them: the reference's host
    helpers on host copies of the tile liveness, which is summed from the
    whole sorted and permuted mask; the port's own point order."""
    N, T = grid.mask.shape
    t_pad = -(-T // 8) * 8
    n_pad = -(-N // max(block_np, cost_block_np)) * max(block_np,
                                                        cost_block_np)
    n_live, n_full, n_tiles = -(-N // block_np), N // block_np, n_pad // block_np

    def liveness(order, cp, bn):
        m = torch.zeros((n_pad, t_pad), dtype=grid.mask.dtype)
        m[:N, :T] = grid.mask[order][:, cp]
        return as_np(m.reshape(n_pad // bn, bn, t_pad // 8, 8)
                     .sum(dim=(1, 3)) > 0.5)

    best = None
    for cell_perm in _cell_orderings(as_np(grid.mask.T @ grid.mask),
                                     ("identity", "rcm", "spectral")):
        cp = torch.as_tensor(cell_perm)
        order = _point_order(grid.mask, cp)
        starts, covers = jrb._covers_from_liveness(
            liveness(order, cp, block_np))
        work = int(jrb._partition_widths(covers[:n_live], max_groups).sum())
        if best is None or work < best[0]:
            best = (work, cell_perm, as_np(order), starts, covers)
    _, cell_perm, order, starts, covers = best
    tile_order_full, lin_groups = jrb._group_tiles(covers[:n_full],
                                                   max_groups)
    if n_full < n_tiles:
        lin_groups += ((max(int(covers[n_full:].max()), 1) * 8, n_full,
                        n_tiles),)
    starts = starts[np.concatenate([tile_order_full,
                                    np.arange(n_full, n_tiles)])]
    rows = order[:n_full * block_np].reshape(n_full, block_np)
    order = np.concatenate([rows[tile_order_full].reshape(-1),
                            order[n_full * block_np:]])
    starts_cost, covers_cost = jrb._covers_from_liveness(
        liveness(torch.as_tensor(order), torch.as_tensor(cell_perm),
                 cost_block_np))
    return {"perm": order, "inv": np.argsort(order), "cell_perm": cell_perm,
            "starts": starts, "starts_cost": starts_cost,
            "lin_groups": lin_groups,
            "cost_groups": jrb._partition_sequence(covers_cost,
                                                   max_groups_cost, t_pad)}


@pytest.fixture(scope="module")
def occlusion_6k():
    """A larger occluded rig: 94 point tiles of 64 at 6,000 points."""
    return tmake_grid(n_arc=3, n_ring=16, n_points=6000, occlusion_rings=4,
                      visibility=0.9, seed=3, dtype=torch.float64,
                      device="cpu")[1]


@pytest.mark.parametrize("rig,block_np,cost_block_np", [
    ("occlusion", 64, 128), ("occlusion", 256, 1024),
    ("occlusion_6k", 64, 128), ("occlusion_6k", 256, 1024)])
def test_band_grid_matches_loop_forms(request, rig, block_np, cost_block_np):
    """The array-program prep returns, bit for bit, the point order, cell
    order, start tables and width groups of the loop forms."""
    grid = request.getfixturevalue(rig)
    grid = grid_to_torch(grid[1]) if rig == "occlusion" else grid
    want = _loop_band_tables(grid, block_np, cost_block_np)
    got = band_grid(grid, block_np=block_np, cost_block_np=cost_block_np)
    assert got.lin_groups == want["lin_groups"]
    assert got.cost_groups == want["cost_groups"]
    for name, a in (("perm", got.perm), ("inv", got.inv),
                    ("cell_perm", got.cell_perm),
                    ("starts", got.grid.band[0]),
                    ("starts_cost", got.grid.band[1])):
        assert a.dtype == (torch.int32 if "starts" in name else torch.int64)
        np.testing.assert_array_equal(as_np(a), want[name], err_msg=name)


def test_band_grid_carries_nothing_between_calls(occlusion, occlusion_6k):
    """Two preps of one grid, with another grid's prep between them, are
    equal and share no tensor; the first is left as it was."""
    grid = grid_to_torch(occlusion[1])
    a = band_grid(grid, block_np=64, cost_block_np=128)
    kept = [t.clone() for t in (a.perm, a.inv, *a.grid.band[:2])]
    band_grid(occlusion_6k, block_np=64, cost_block_np=128)
    b = band_grid(grid, block_np=64, cost_block_np=128)
    assert (a.lin_groups, a.cost_groups) == (b.lin_groups, b.cost_groups)
    for k, x, y in zip(kept, (a.perm, a.inv, *a.grid.band[:2]),
                       (b.perm, b.inv, *b.grid.band[:2])):
        assert torch.equal(k, x) and torch.equal(x, y)
        assert x.data_ptr() != y.data_ptr()


def test_band_prep_invariants(occlusion):
    """Every live cell of every point tile lies inside its cyclic band, and
    the permutation is a bijection."""
    _, jgrid = occlusion
    tgrid = grid_to_torch(jgrid)
    prep = band_grid(tgrid, block_np=64, cost_block_np=128)
    t_pad = -(-tgrid.mask.shape[1] // 8) * 8
    mask, starts = as_np(prep.grid.mask), as_np(prep.grid.band[0])
    widths = {}
    for w, lo, hi in prep.lin_groups:
        for i in range(lo, hi):
            widths[i] = w
    for i, s0 in enumerate(starts):
        rows = mask[i * 64:(i + 1) * 64]
        live = np.nonzero(rows.any(axis=0))[0]
        assert ((live - s0 * 8) % t_pad < widths[i]).all(), (i, s0, live)
    perm, inv = as_np(prep.perm), as_np(prep.inv)
    assert (perm[inv] == np.arange(perm.size)).all()
    assert np.isclose(mask.sum(), as_np(tgrid.mask).sum())


def test_band_grid_declines_without_locality():
    """Dense and uniform-random masks fall back to the monolithic kernels,
    as the reference's band_grid does (tests/test_rig_band.py)."""
    _, dense, _ = make_grid_rig_device(
        n_arc=3, n_ring=16, n_points=256, occlusion_rings=None,
        visibility=None, seed=1, dtype=jnp.float64)
    _, rand, _ = make_grid_rig_device(
        n_arc=3, n_ring=16, n_points=256, occlusion_rings=None,
        visibility=0.2, seed=1, dtype=jnp.float64)
    for g in (dense, rand):
        assert jband_grid(g, block_np=64) is None
        assert band_grid(grid_to_torch(g), block_np=64) is None


def test_banded_planes_gather_matches_jax(occlusion):
    """The port's plane stacks, gathered from the reference's band-prepped
    grid and start tables, equal the reference's stacks."""
    _, jgrid = occlusion
    prep = jband_grid(jgrid, block_np=64, cost_block_np=128)
    tgrid = grid_to_torch(prep.grid)
    n_pad = -(-tgrid.mask.shape[0] // 128) * 128
    w_max = max(prep.w_band, prep.w_band_cost)
    pxm_ext = tk.banded_planes(tgrid, n_pad, w_max)
    np.testing.assert_array_equal(
        as_np(pxm_ext), np.asarray(jk.banded_planes(prep.grid, n_pad, w_max)))
    starts = torch.as_tensor(np.asarray(prep.grid.band[0]))
    for (w, lo, hi), want in zip(prep.lin_groups, prep.grid.band[2]):
        got = tk.gather_banded_planes(pxm_ext, starts, w, 64, lo, hi)
        np.testing.assert_array_equal(as_np(got), np.asarray(want))


def test_band_grid_update_refuses_a_grown_mask(occlusion):
    _, jgrid = occlusion
    tgrid = grid_to_torch(jgrid)
    prep = band_grid(tgrid, block_np=64, cost_block_np=128)
    # a filter round removes observations: the stored covers are reused
    shrunk = dataclasses.replace(tgrid, mask=tgrid.mask.clone())
    shrunk.mask[0] = 0.0
    upd = band_grid_update(prep, shrunk)
    assert upd.lin_groups == prep.lin_groups
    assert float(upd.grid.mask.sum()) == float(shrunk.mask.sum())
    # a mask with more live observations than the prep saw is refused
    grown = dataclasses.replace(tgrid, mask=torch.ones_like(tgrid.mask))
    with pytest.raises(ValueError, match="run band_grid"):
        band_grid_update(prep, grown)


def test_band_grid_update_refuses_a_moved_observation(occlusion):
    """A mask that drops one observation and adds one that was dead at
    prep time keeps the live count; the update refuses it all the same
    (the new cell may lie outside its tile's stored band), and still takes
    a mask that only removes observations."""
    _, jgrid = occlusion
    tgrid = grid_to_torch(jgrid)
    prep = band_grid(tgrid, block_np=64, cost_block_np=128)
    live = tgrid.mask.nonzero()
    dead = (tgrid.mask == 0).nonzero()
    moved = dataclasses.replace(tgrid, mask=tgrid.mask.clone())
    moved.mask[tuple(live[0])] = 0.0
    moved.mask[tuple(dead[len(dead) // 2])] = 1.0
    assert float(moved.mask.sum()) == float(tgrid.mask.sum())
    with pytest.raises(ValueError, match="1 live observations were dead"):
        band_grid_update(prep, moved)
    removed = dataclasses.replace(tgrid, mask=tgrid.mask.clone())
    removed.mask[tuple(live[0])] = 0.0
    upd = band_grid_update(prep, removed)
    assert float(upd.grid.mask.sum()) == float(tgrid.mask.sum()) - 1


def test_band_start_guard_runs_at_prep_and_refuses_a_start_outside(occlusion):
    """The band-start check left the kernels' call path: a stored prep
    whose start table points past the cell table is refused where the
    prep hands the tables over (``band_grid_update``, so also
    ``solve_ba_grid``'s set-up with ``band_reuse``), and by a wrapper that
    gathers the planes itself; given the prep's stacks, a wrapper reads
    no start back."""
    from deeparc_tpu_torch.scene import freeze_masks
    from deeparc_tpu_torch.solver.rig_grid import slot_params, solve_ba_grid

    data, jgrid = occlusion
    tgrid = grid_to_torch(jgrid)
    prep = band_grid(tgrid, block_np=64, cost_block_np=128)
    t_pad = -(-tgrid.xy0.shape[1] // 8) * 8
    bad = prep.grid.band[0].clone()
    bad[1] = t_pad // 8
    stored = prep._replace(grid=dataclasses.replace(
        prep.grid, band=(bad, prep.grid.band[1])))
    with pytest.raises(ValueError, match="band start outside the cell table"):
        band_grid_update(stored, tgrid)
    scene = from_deeparc(data, device="cpu")
    with pytest.raises(ValueError, match="band start outside the cell table"):
        solve_ba_grid(scene.params, grid_from_scene(scene),
                      freeze_masks(scene), band_reuse={"prep": stored})
    g = prep.grid
    params = scene.params
    sp = slot_params(dataclasses.replace(
        params, points=params.points[prep.perm.long()]), g)
    w = prep.lin_groups
    with pytest.raises(ValueError, match="band start outside the cell table"):
        tk.cost_grid_banded(params.points[prep.perm.long()], sp, g, bad, w,
                            block_np=64)
    # with the prep's own stacks the wrapper takes the table as given
    cost = tk.cost_grid_banded(params.points[prep.perm.long()], sp, g,
                               prep.grid.band[1], prep.cost_groups,
                               block_np=128, pxm=prep.grid.band[3])
    assert torch.isfinite(cost)

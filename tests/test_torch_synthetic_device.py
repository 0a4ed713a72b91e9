"""Port parity: the device-side scene generators of ``deeparc_tpu_torch.io``
against ``deeparc_tpu.io.synthetic``, on the CPU in float64.

The generators' draws on the device cannot match JAX's threefry streams,
so parity is:
  (a) every value drawn or built on the host, bit for bit (camera tables,
      slot tables and one-hots, cell columns, bucket widths and padding,
      row maps, chunk tables, tile masks);
  (b) with no pixel noise, the observations equal the JAX package's
      projection of the port's own ground truth on the live slots (1e-10
      relative): ``rig_grid.grid_residuals`` for the grid, the
      per-observation ``residuals`` for the tile layouts;
  (c) the heavy-tail invariants of tests/test_heavytail.py, and distinct
      live camera ids in every row of the two BAL generators (the
      reference's ``make_bal_tile_device`` wraps duplicates onto held ids);
  (d) two LM steps of the port's engine against two of the JAX package's
      on the same layout (its XLA impls: ``einsum`` for the grid, ``xla``
      for the tiles; Pallas in interpret mode would cost minutes of
      compiles), with the engines' parity
      tolerances (grid: cost 1e-6, iterates 1e-5; tiles: cost 1e-9,
      iterates 1e-7), then a short port solve whose cost falls;
  (e) asking for the card without one raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.config import SolverOptions as JSolverOptions
from deeparc_tpu.io import synthetic as jsyn
from deeparc_tpu.residuals.reprojection import residuals as jresiduals
from deeparc_tpu.scene import SceneIndex as JSceneIndex
from deeparc_tpu.solver import rig_grid as jrg
from deeparc_tpu.solver import tiles as jt
from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.io import synthetic as tsyn
from deeparc_tpu_torch.solver import rig_grid as trg
from deeparc_tpu_torch.solver import tiles as tt
from torch_parity import as_np, close, grid_to_jax, params_to_jax, tiles_to_jax

# small scenes of each generator (the BAL one at the size where the
# reference's duplicate shift shows)
SCENES = {
    "grid": (dict(n_arc=3, n_ring=6, n_points=64, visibility=0.7,
                  occlusion_rings=4, seed=5), "make_grid_rig_device"),
    "tile_rig": (dict(n_arc=3, n_ring=6, n_points=64, track_length=5,
                      chunk_obs=256, seed=5), "make_tile_rig_device"),
    "bal_tile": (dict(n_cameras=256, n_points=4096, track_length=8,
                      window=16, chunk_obs=256, seed=0),
                 "make_bal_tile_device"),
    "heavytail": (dict(n_cameras=32, n_points=400, mean_track=5.0, sigma=0.8,
                       max_track=32, window=16, chunk_obs=256, seed=3),
                  "make_bal_heavytail_device"),
}
NOISE = dict(pixel_noise=0.5, point_noise=0.03)
# the steps' scenes: the BAL one cut to a size two steps take quickly
STEP_SCENES = {**{k: v[0] for k, v in SCENES.items()},
               "bal_tile": dict(n_cameras=32, n_points=256, track_length=6,
                                window=16, chunk_obs=256, seed=4)}
PARAM_TABLES = ("ext_rot", "ext_trans", "center", "focal", "dist")


def _port(name, kw, **extra):
    fn = getattr(tsyn, SCENES[name][1])
    return fn(**{**kw, **extra}, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def reference():
    """Each reference generator called once, lazily."""
    made = {}

    def get(name):
        if name not in made:
            kw, fn = SCENES[name]
            made[name] = getattr(jsyn, fn)(**kw, **NOISE, dtype=jnp.float64)
        return made[name]

    return get


def _eq(got, want):
    np.testing.assert_array_equal(as_np(got), np.asarray(want))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_host_values_match_reference(name, reference):
    want = reference(name)
    got = _port(name, SCENES[name][0], **NOISE)
    for f in PARAM_TABLES:
        _eq(getattr(got[0], f), getattr(want[0], f))
    assert got[0].points.shape == want[0].points.shape
    if name == "grid":
        for f in jrg.GridIndex._fields:
            if f in ("xy0", "xy1", "mask", "band"):
                continue
            _eq(getattr(got[1], f), getattr(want[1], f))
        assert got[1].mask.shape == want[1].mask.shape
        return
    tiles, wtiles = got[1], want[1]
    for f in jt.CellTable._fields:
        _eq(getattr(tiles.cells, f), getattr(wtiles.cells, f))
    _eq(got[3], want[3])
    _eq(tiles.row_of_point, wtiles.row_of_point)
    assert len(tiles.buckets) == len(wtiles.buckets)
    for b, wb in zip(tiles.buckets, wtiles.buckets):
        assert b.cell.shape == wb.cell.shape    # width and padded rows
        _eq(b.mask, wb.mask)
        assert len(b.loc) == len(wb.loc)
        if b.loc:
            _eq(b.loc[1], wb.loc[1])
    if name == "tile_rig":
        _eq(tiles.buckets[0].loc[0], tiles.buckets[0].cell)


def _obs_index(tiles, gt, K):
    """The live slots of a tile layout as a JAX SceneIndex with xy = 0,
    and the port's observed pixels there."""
    cells = tiles.cells
    rows, cols, xy = [], [], []
    off = 0
    for b in tiles.buckets:
        live = as_np(b.mask) > 0.5
        r, w = np.nonzero(live)
        rows.append(off + r)
        cols.append(as_np(b.cell)[r, w])
        xy.append(np.stack([as_np(b.xy0)[r, w], as_np(b.xy1)[r, w]], 1))
        off += b.cell.shape[0]
    rows, cols, xy = np.concatenate(rows), np.concatenate(cols), \
        np.concatenate(xy)
    intr = as_np(cells.slot_intr)
    per_k = lambda a: np.bincount(intr, weights=as_np(a), minlength=K) \
        / np.maximum(np.bincount(intr, minlength=K), 1)
    i32 = lambda a: jnp.asarray(np.asarray(a, np.int32))
    index = JSceneIndex(
        obs_point=i32(rows), obs_outer=i32(as_np(cells.slot_outer)[cols]),
        obs_inner=i32(as_np(cells.slot_inner)[cols]), obs_intr=i32(intr[cols]),
        obs_xy=jnp.zeros((rows.size, 2)), obs_mask=jnp.ones(rows.size),
        point_mask=jnp.ones(gt.shape[0]),
        focal_shared=jnp.asarray(per_k(cells.focal_shared)),
        dist_m1=jnp.asarray(per_k(cells.dist_m1)),
        dist_m2=jnp.asarray(per_k(cells.dist_m2)))
    return index, xy


@pytest.mark.parametrize("name", sorted(SCENES))
def test_observations_are_jax_projections_of_the_ground_truth(name):
    kw = STEP_SCENES[name]
    out = _port(name, kw, pixel_noise=0.0)
    params, layout, gt = out[0], out[1], out[2]
    jparams = dataclasses.replace(params_to_jax(params),
                                  points=jnp.asarray(as_np(gt)))
    if name == "grid":
        jgrid = grid_to_jax(layout)
        zero = jnp.zeros_like(jgrid.xy0)
        pred = jrg.grid_residuals(
            jparams.points, jrg.slot_params(jparams, jgrid),
            jgrid._replace(xy0=zero, xy1=zero, mask=jnp.ones_like(zero)))
        live = as_np(layout.mask) > 0.5
        assert live.sum() > 0
        want = np.asarray(pred)[live]
        got = np.stack([as_np(layout.xy0)[live], as_np(layout.xy1)[live]], 1)
    else:
        index, got = _obs_index(layout, gt, params.center.shape[0])
        want = np.asarray(jax.jit(jresiduals)(jparams, index))
    np.testing.assert_allclose(got, want, rtol=1e-10,
                               atol=1e-10 * np.abs(want).max())


def test_heavytail_invariants():
    """tests/test_heavytail.py:32-51 on the port's scene."""
    params, tiles, gt, cam_free = _port("heavytail", STEP_SCENES["heavytail"],
                                        **NOISE)
    n_points = STEP_SCENES["heavytail"]["n_points"]
    assert len(tiles.buckets) >= 3, "log-normal tracks must span buckets"
    widths = [b.cell.shape[1] for b in tiles.buckets]
    assert widths == sorted(widths)
    total = 0
    for b in tiles.buckets:
        m = as_np(b.mask)
        assert (m.sum(axis=1) <= b.cell.shape[1]).all()
        total += m.sum()
    assert total > n_points * 2
    assert any(tt.bucket_fused_ok(b) for b in tiles.buckets)
    V = int(tiles.cells.slot_outer.shape[0])
    for b in tiles.buckets:
        cells = as_np(b.cell)[as_np(b.mask) > 0.5]
        assert cells.min() >= 0 and cells.max() < V
        assert b.bins or b.cell.shape[1] > tt.MAX_KERNEL_WIDTH
        assert b.pieces
    assert tiles.cells.maps


def _duplicated_rows(cell, mask) -> int:
    """Rows holding one camera id in two live slots."""
    c = np.where(mask > 0.5, cell, -1 - np.arange(cell.shape[1]))
    s = np.sort(c, axis=1)
    return int(np.any(s[:, 1:] == s[:, :-1], axis=1).sum())


@pytest.mark.parametrize("name", ["bal_tile", "heavytail"])
def test_bal_rows_hold_distinct_cameras(name, reference):
    """At n_cameras=256, n_points=4096, track 8, window 16 the reference's
    (sort + cumsum(dup)) % window shift leaves duplicated ids in some
    rows; the port's sorted draws plus rank never do."""
    kw = dict(SCENES["bal_tile"][0])
    if name == "heavytail":
        kw.pop("track_length")
        kw["mean_track"] = 8.0
    else:
        b = reference(name)[1].buckets[0]
        assert _duplicated_rows(np.asarray(b.cell), np.asarray(b.mask)) > 0
    tiles = _port(name, kw, **NOISE)[1]
    for b in tiles.buckets:
        assert _duplicated_rows(as_np(b.cell), as_np(b.mask)) == 0
        if b.loc:
            assert _duplicated_rows(as_np(b.loc[0]), as_np(b.mask)) == 0


def _grid_free(params):
    """Points and the extrinsics free but record 0 and the identity row;
    the intrinsics frozen (the reference's standard BA mode)."""
    R, K = params.ext_rot.shape[0], params.center.shape[0]
    ext = np.ones((R, 6))
    ext[0] = ext[R - 1] = 0.0
    return np.concatenate([ext.reshape(-1), np.zeros(6 * K)])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_two_steps_match_jax_and_a_solve_lowers_the_cost(name):
    out = _port(name, STEP_SCENES[name], **NOISE)
    params, layout = out[0], out[1]
    jparams = params_to_jax(params)
    pf = torch.ones_like(params.points)
    if name == "grid":
        cam_free_np = _grid_free(params)
        cam_free = torch.tensor(cam_free_np)
        jlayout = grid_to_jax(layout)
        jstep = jax.jit(jrg.make_grid_step(JSolverOptions(), jparams,
                                           chunk_size=32, impl="einsum"))
        jstate = jrg.init_grid_state(jparams, jlayout, JSolverOptions(),
                                     impl="einsum")
        tstep = trg.make_grid_step(SolverOptions(), params, chunk_size=32)
        tstate = trg.init_grid_state(params, layout, SolverOptions())
        rtol_cost, rtol_x, atol_x = 1e-6, 1e-5, 1e-8
    else:
        cam_free = out[3]
        cam_free_np = as_np(cam_free)
        opts = dict(linear_solver="iterative_schur", cg_max_iterations=20,
                    cg_tolerance=1e-14)
        jlayout = tiles_to_jax(layout)
        jstep = jax.jit(jt.make_tile_step(JSolverOptions(**opts), jparams,
                                          256))
        jstate = jt.init_tile_state(jparams, jlayout, JSolverOptions(**opts),
                                    jnp.asarray(cam_free_np), chunk_obs=256)
        tstep = tt.make_tile_step(SolverOptions(**opts), params)
        tstate = tt.init_tile_state(params, layout, SolverOptions(**opts),
                                    cam_free)
        rtol_cost, rtol_x, atol_x = 1e-9, 1e-7, 1e-10
    close(tstate.cost, jstate.cost, rtol=rtol_cost)
    cost0 = float(tstate.cost)
    for _ in range(2):
        jstate, jinfo = jstep(jstate, jlayout, jnp.asarray(cam_free_np),
                              jnp.asarray(as_np(pf)))
        tstate, tinfo = tstep(tstate, layout, cam_free, pf)
        assert bool(tinfo.accepted) == bool(jinfo.accepted)
        close(tinfo.cost, jinfo.cost, rtol=rtol_cost)
        close(tstate.points, jstate.points, rtol=rtol_x, atol=atol_x)
        close(tstate.cam_vec, jstate.cam_vec, rtol=rtol_x, atol=atol_x)
    assert float(tstate.cost) < cost0

    # a short solve by the port's entry point lowers the cost
    quiet = dict(max_iterations=3, progress_to_stdout=False)
    if name == "grid":
        free = dataclasses.replace(
            params, points=pf,
            ext_rot=cam_free[:6 * params.ext_rot.shape[0]].reshape(-1, 6)
            [:, :3].contiguous(),
            ext_trans=cam_free[:6 * params.ext_rot.shape[0]].reshape(-1, 6)
            [:, 3:].contiguous(),
            center=torch.zeros_like(params.center),
            focal=torch.zeros_like(params.focal),
            dist=torch.zeros_like(params.dist))
        res = trg.solve_ba_grid(params, layout, free, SolverOptions(**quiet))
    else:
        res = tt.solve_tiles_prepared(params, layout, pf, cam_free,
                                      SolverOptions(**opts, **quiet))
    assert res.iterations > 0 and res.cost < cost0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_cuda_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(tsyn, SCENES[name][1])(**STEP_SCENES[name])

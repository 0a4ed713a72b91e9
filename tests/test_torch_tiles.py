"""Port parity: the tile engine (PyTorch port on the CPU, kernels' plain
versions) against ``deeparc_tpu.solver.tiles``.

The host prep is the same numpy code, so its layouts are identical. The
cost is one sum in another order: rtol 1e-12. Two LM steps against JAX
``make_tile_step(impl="pallas")`` (Pallas in interpret mode) take the same
accept decisions with cost rtol 1e-9 and iterates rtol 1e-7 (the tolerances
of tests/test_tiles.py:94-102). The filter's masks are identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.config import FilterOptions, SolverOptions
from deeparc_tpu.io.deeparc_format import DeepArcData
from deeparc_tpu.io.synthetic import make_bal_synthetic, make_bal_windowed_host
from deeparc_tpu.pipeline.filtering import filter_masks_tiles as jfilter
from deeparc_tpu.residuals.reprojection import flatten_camera as jflatten
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver import tiles as jt
from deeparc_tpu.solver.rig_grid import slot_params as jslot_params
from deeparc_tpu_torch.pipeline.filtering import filter_masks_tiles
from deeparc_tpu_torch.residuals.reprojection import flatten_camera
from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
from deeparc_tpu_torch.solver import tiles as tt
from deeparc_tpu_torch.solver.rig_grid import slot_params
from torch_parity import as_np, close


def _rcm_fixture():
    """The shuffled-window scene of tests/test_tiles.py:246-283."""
    rng = np.random.default_rng(0)
    n_cam, n_pts, track, window = 64, 512, 4, 8
    latent_start = (np.arange(n_pts) * (n_cam - window)) // (n_pts - 1)
    cams_latent = np.stack([
        latent_start[i] + rng.choice(window, track, replace=False)
        for i in range(n_pts)])
    shuffle = rng.permutation(n_cam)
    obs_cam = shuffle[cams_latent].reshape(-1).astype(np.int32)
    obs_point = np.repeat(np.arange(n_pts, dtype=np.int32), track)
    return DeepArcData(
        version=0.01, share_extrinsic=False, arc_size=n_cam, ring_size=0,
        obs_arc=obs_cam, obs_ring=obs_cam.copy(), obs_point=obs_point,
        obs_xy=rng.uniform(100.0, 900.0, size=(obs_point.size, 2)),
        center=np.tile([512.0, 512.0], (n_cam, 1)),
        focal=np.concatenate(
            [np.full((n_cam, 1), 800.0), np.zeros((n_cam, 1))], axis=1),
        focal_size=np.ones(n_cam, dtype=np.int32),
        dist=np.zeros((n_cam, 2)), dist_size=np.zeros(n_cam, dtype=np.int32),
        ext_rot=rng.normal(scale=0.1, size=(n_cam, 3)),
        ext_trans=np.concatenate([rng.normal(scale=0.1, size=(n_cam, 2)),
                                  np.full((n_cam, 1), 3.0)], axis=1),
        points=rng.normal(scale=0.3, size=(n_pts, 3)),
        colors=rng.integers(0, 256, size=(n_pts, 3)).astype(np.int32))


SCENES = {
    "hub_windowed": (lambda: make_bal_windowed_host(
        n_cameras=64, n_points=1500, track_length=8, window=16, n_hubs=4,
        hub_frac=0.15, seed=3), 1024),
    "rcm_fixture": (_rcm_fixture, 512),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tiles_from_scene_layout_identical(name):
    make, chunk_obs = SCENES[name]
    data = make()
    js = jfrom_deeparc(data)
    want, wparams, wfree, wsrc = jt.tiles_from_scene(
        js, jfreeze(js), chunk_obs=chunk_obs, with_slot_src=True)
    ts = from_deeparc(data, device="cpu")
    got, gparams, gfree, gsrc = tt.tiles_from_scene(
        ts, freeze_masks(ts), chunk_obs=chunk_obs, with_slot_src=True)
    if name == "hub_windowed":
        assert any(b.loc for b in want.buckets)
    for f in want.cells._fields:
        np.testing.assert_array_equal(as_np(getattr(got.cells, f)),
                                      np.asarray(getattr(want.cells, f)))
    assert len(got.buckets) == len(want.buckets)
    for gb, wb, gs, ws in zip(got.buckets, want.buckets, gsrc, wsrc):
        for f in ("cell", "xy0", "xy1", "mask"):
            np.testing.assert_array_equal(as_np(getattr(gb, f)),
                                          np.asarray(getattr(wb, f)))
        assert len(gb.loc) == len(wb.loc)
        for g, w in zip(gb.loc, wb.loc):
            np.testing.assert_array_equal(as_np(g), np.asarray(w))
        np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(as_np(got.row_of_point),
                                  np.asarray(want.row_of_point))
    np.testing.assert_array_equal(as_np(gparams.points),
                                  np.asarray(wparams.points))
    np.testing.assert_array_equal(as_np(gfree), np.asarray(wfree))
    back = tt.unpermute_points(gparams.points, got)
    np.testing.assert_array_equal(as_np(back), data.points)


def _bal_problem():
    return make_bal_synthetic(n_cameras=12, n_points=150, track_length=5.0,
                              pixel_noise=0.5, point_noise=0.03, seed=3).data


@pytest.mark.parametrize("loss", ["trivial", "cauchy"])
def test_tile_cost_matches_jax(loss):
    data = _bal_problem()
    js = jfrom_deeparc(data)
    jfree = jfreeze(js)
    tiles, params_t, _ = jt.tiles_from_scene(js, jfree, chunk_obs=256)
    want = jt.tile_cost(params_t.points, jt.pack_cells(
        jslot_params(params_t, tiles.cells), tiles.cells, jflatten(jfree)),
        tiles, 256, loss, 1.0)
    ts = from_deeparc(data, device="cpu")
    free = freeze_masks(ts)
    tiles_p, params_p, _ = tt.tiles_from_scene(ts, free, chunk_obs=256)
    got = tt.tile_cost(params_p.points, tt.pack_cells(
        slot_params(params_p, tiles_p.cells), tiles_p.cells,
        flatten_camera(free)), tiles_p, loss, 1.0)
    close(got, want, rtol=1e-12)


@pytest.mark.parametrize("locality", [True, False])
def test_tile_step_matches_jax_pallas(locality):
    """Two LM steps: JAX impl='pallas' (interpret-mode sweeps) against the
    port's step (plain kernels) on the loc'd and the global layout."""
    data = _bal_problem()
    opts = SolverOptions(linear_solver="iterative_schur",
                         cg_max_iterations=20, cg_tolerance=1e-14)
    js = jfrom_deeparc(data)
    jfree = jfreeze(js)
    tiles, params_t, free_t = jt.tiles_from_scene(js, jfree, chunk_obs=256,
                                                  locality=locality)
    assert any(b.loc for b in tiles.buckets) == locality
    jcam_free = jflatten(jfree)
    step = jax.jit(jt.make_tile_step(opts, params_t, 256, impl="pallas"))
    jstate = jt.init_tile_state(params_t, tiles, opts, jcam_free,
                                chunk_obs=256)
    ts = from_deeparc(data, device="cpu")
    free = freeze_masks(ts)
    tiles_p, params_p, free_p = tt.tiles_from_scene(ts, free, chunk_obs=256,
                                                    locality=locality)
    cam_free = flatten_camera(free)
    tstep = tt.make_tile_step(opts, params_p)
    tstate = tt.init_tile_state(params_p, tiles_p, opts, cam_free)
    close(tstate.cost, jstate.cost, rtol=1e-12)
    for _ in range(2):
        jstate, jinfo = step(jstate, tiles, jcam_free, free_t)
        tstate, tinfo = tstep(tstate, tiles_p, cam_free, free_p)
        assert bool(tinfo.accepted) == bool(jinfo.accepted)
        close(tinfo.cost, jinfo.cost, rtol=1e-9)
        close(tstate.points, jstate.points, rtol=1e-7, atol=1e-10)
        close(tstate.cam_vec, jstate.cam_vec, rtol=1e-7, atol=1e-10)
        assert tinfo.cg_iters > 0


@pytest.mark.parametrize("inverted", [False, True])
def test_filter_masks_tiles_identical(inverted):
    data = _bal_problem()
    opts = FilterOptions(error_boundary=0.3, parity_inverted=inverted)
    js = jfrom_deeparc(data)
    tiles, params_t, _ = jt.tiles_from_scene(js, jfreeze(js), chunk_obs=256)
    center = jnp.asarray([0.05, -0.02, 0.01])
    want_m, want_r = jfilter(params_t.points, params_t, tiles, center, 1.5,
                             opts)
    ts = from_deeparc(data, device="cpu")
    tiles_p, params_p, _ = tt.tiles_from_scene(ts, freeze_masks(ts),
                                               chunk_obs=256)
    got_m, got_r = filter_masks_tiles(
        params_p.points, params_p, tiles_p,
        torch.tensor([0.05, -0.02, 0.01], dtype=torch.float64), 1.5, opts)
    np.testing.assert_array_equal(as_np(got_r), np.asarray(want_r))
    assert 0 < float(got_r.sum()) < got_r.numel()
    for g, w in zip(got_m, want_m):
        np.testing.assert_array_equal(as_np(g), np.asarray(w))

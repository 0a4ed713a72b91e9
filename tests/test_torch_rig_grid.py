"""Port parity: the grid engine's LM step and solve (PyTorch port vs JAX).

Two classic LM steps through the kernel path of both packages (the JAX
Pallas kernels in interpret mode, the port's plain versions on the CPU)
must take the same accept decisions and land on the same iterates: cost
rtol 1e-6, points and camera vector rtol 1e-5 (the pattern of
tests/test_pallas_kernels.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.config import SolverOptions
from deeparc_tpu.io import make_hemisphere_rig
from deeparc_tpu.residuals.reprojection import flatten_camera as jflatten
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver import rig_grid as jrg
from deeparc_tpu.solver.rig_band import band_grid as jband_grid
from deeparc_tpu_torch.residuals.reprojection import flatten_camera
from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
from deeparc_tpu_torch.solver import rig_grid as trg
from torch_parity import close, grid_to_torch, params_to_torch

OPTIONS = SolverOptions(linear_solver="dense_schur")


def _two_steps_jax(params, grid, cam_free, point_free, **kw):
    step = jax.jit(jrg.make_grid_step(OPTIONS, params, chunk_size=32,
                                      impl="pallas", **kw))
    state = jrg.init_grid_state(
        params, grid, OPTIONS, impl="pallas",
        band_widths=kw.get("band_widths", (0, 0)),
        band_blocks=kw.get("band_blocks", (0, 0)))
    infos = []
    for _ in range(2):
        state, info = step(state, grid, cam_free, point_free)
        infos.append(bool(info.accepted))
    return state, infos


def _two_steps_torch(params, grid, cam_free, point_free, **kw):
    step = trg.make_grid_step(OPTIONS, params, chunk_size=32, **kw)
    state = trg.init_grid_state(
        params, grid, OPTIONS, band_widths=kw.get("band_widths", (0, 0)),
        band_blocks=kw.get("band_blocks", (0, 0)))
    infos = []
    for _ in range(2):
        state, info = step(state, grid, cam_free, point_free)
        infos.append(bool(info.accepted))
    return state, infos


def _check(got, want):
    (s_t, acc_t), (s_j, acc_j) = got, want
    assert acc_t == acc_j
    close(s_t.cost, s_j.cost, 1e-6)
    close(s_t.points, s_j.points, 1e-5, 1e-8)
    close(s_t.cam_vec, s_j.cam_vec, 1e-5, 1e-8)


@pytest.mark.parametrize("kw", [dict(focal_size=1, dist_size=0),
                                dict(focal_size=2, dist_size=2)])
def test_monolithic_steps_match_jax(kw):
    rig = make_hemisphere_rig(n_arc=3, n_ring=5, n_points=50, pixel_noise=0.5,
                              point_noise=0.04, visibility=0.8, seed=31, **kw)
    scene = jfrom_deeparc(rig.data)
    grid, free = jrg.grid_from_scene(scene), jfreeze(scene)
    want = _two_steps_jax(scene.params, grid, jflatten(free), free.points)
    tfree = params_to_torch(free)
    got = _two_steps_torch(params_to_torch(scene.params), grid_to_torch(grid),
                           flatten_camera(tfree), tfree.points)
    _check(got, want)


@pytest.fixture(scope="module")
def banded():
    rig = make_hemisphere_rig(n_arc=3, n_ring=16, n_points=420,
                              occlusion_rings=4, visibility=0.9,
                              pixel_noise=0.8, point_noise=0.02, seed=5)
    scene = jfrom_deeparc(rig.data)
    prep = jband_grid(jrg.grid_from_scene(scene), block_np=64,
                      cost_block_np=128)
    tg = grid_to_torch(prep.grid)
    t = lambda a: torch.as_tensor(np.array(a))
    b = prep.grid.band
    tg.band = (t(b[0]), t(b[1]), tuple(t(p) for p in b[2]),
               tuple(t(p) for p in b[3]))
    params = dataclasses.replace(
        scene.params, points=scene.params.points[np.asarray(prep.perm)])
    return prep, tg, params


@pytest.mark.parametrize("intr_frozen", [False, True])
def test_banded_steps_match_jax(banded, intr_frozen):
    prep, tg, params = banded
    R = params.ext_rot.shape[0]
    cam_free = np.ones(6 * (R + params.center.shape[0]))
    cam_free[:6] = 0.0                      # gauge extrinsic
    if intr_frozen:
        cam_free[6 * R:] = 0.0              # the reference's BA mode
    point_free = np.ones(np.asarray(params.points).shape)
    bws, bbs = prep.widths
    kw = dict(band_widths=bws, band_blocks=bbs, band_intr_frozen=intr_frozen)
    want = _two_steps_jax(params, prep.grid, jnp.asarray(cam_free),
                          jnp.asarray(point_free), **kw)
    got = _two_steps_torch(params_to_torch(params), tg,
                           torch.as_tensor(cam_free),
                           torch.as_tensor(point_free), **kw)
    _check(got, want)


def _solve_inputs():
    rig = make_hemisphere_rig(n_arc=3, n_ring=16, n_points=300,
                              occlusion_rings=4, visibility=0.9,
                              pixel_noise=0.8, point_noise=0.02, seed=7)
    return rig.data


def test_solve_ba_grid_band_auto_matches_jax():
    """The port's solve takes the band path (points permuted in, returned
    in original order) and lands where the reference's solve does."""
    data = _solve_inputs()
    jscene = jfrom_deeparc(data)
    res_j = jrg.solve_ba_grid(jscene.params, jrg.grid_from_scene(jscene),
                              jfreeze(jscene),
                              dataclasses.replace(OPTIONS, max_iterations=3),
                              impl="planes", chunk_size=128)
    scene = from_deeparc(data, device="cpu")
    state: dict = {}
    res_t = trg.solve_ba_grid(scene.params, trg.grid_from_scene(scene),
                              freeze_masks(scene),
                              dataclasses.replace(OPTIONS, max_iterations=3),
                              band_reuse=state)
    assert state["prep"] is not None     # the band path was taken
    assert res_t.iterations == 3
    close(res_t.cost, res_j.cost, 1e-6)
    close(res_t.params.points, res_j.params.points, 1e-5, 1e-8)
    close(flatten_camera(res_t.params), jflatten(res_j.params), 1e-5, 1e-8)


def test_band_reuse_keeps_no_planes_and_matches_fresh_prep():
    """The prep stored for reuse across filter rounds holds no plane
    stacks; the next round re-gathers them for the shrunk mask and solves
    exactly as a fresh prep does."""
    scene = from_deeparc(_solve_inputs(), device="cpu")
    grid = trg.grid_from_scene(scene)
    free = freeze_masks(scene)
    options = dataclasses.replace(OPTIONS, max_iterations=2)
    state: dict = {}
    trg.solve_ba_grid(scene.params, grid, free, options, band_reuse=state)
    assert len(state["prep"].grid.band) == 2
    rng = np.random.default_rng(3)
    drop = torch.as_tensor(rng.random(tuple(grid.mask.shape)) < 0.15)
    grid2 = dataclasses.replace(grid, mask=grid.mask * ~drop)
    reuse = trg.solve_ba_grid(scene.params, grid2, free, options,
                              band_reuse=state)
    fresh = trg.solve_ba_grid(scene.params, grid2, free, options)
    close(reuse.cost, fresh.cost, 1e-8)
    close(reuse.params.points, fresh.params.points, 1e-6, 1e-9)


def test_monolithic_solves_across_a_filter_round_match_jax():
    """Two monolithic solves (the band prep declines a 3x5-cell rig) with a
    filtered mask in between, as the pipeline's rounds run them: each solve
    builds the plane stack of its own mask, so the second lands where the
    reference's does; a stack kept from the first solve would not."""
    rig = make_hemisphere_rig(n_arc=3, n_ring=5, n_points=50, pixel_noise=0.5,
                              point_noise=0.04, visibility=0.8, seed=31)
    options = dataclasses.replace(OPTIONS, max_iterations=2)
    jscene = jfrom_deeparc(rig.data)
    jgrid, jfree = jrg.grid_from_scene(jscene), jfreeze(jscene)
    scene = from_deeparc(rig.data, device="cpu")
    tgrid, tfree = trg.grid_from_scene(scene), freeze_masks(scene)
    keep = np.random.default_rng(5).random(tuple(tgrid.mask.shape)) >= 0.3
    state: dict = {}
    res_j = jrg.solve_ba_grid(jscene.params, jgrid, jfree, options,
                              impl="planes", chunk_size=128)
    res_t = trg.solve_ba_grid(scene.params, tgrid, tfree, options,
                              band_reuse=state)
    assert state["prep"] is None          # the monolithic path
    jgrid2 = jgrid._replace(mask=jgrid.mask * jnp.asarray(keep))
    tgrid2 = dataclasses.replace(tgrid, mask=tgrid.mask * torch.as_tensor(keep))
    res_j = jrg.solve_ba_grid(res_j.params, jgrid2, jfree, options,
                              impl="planes", chunk_size=128)
    res_t = trg.solve_ba_grid(res_t.params, tgrid2, tfree, options,
                              band_reuse=state)
    close(res_t.cost, res_j.cost, 1e-6)
    close(res_t.params.points, res_j.params.points, 1e-5, 1e-8)
    close(flatten_camera(res_t.params), jflatten(res_j.params), 1e-5, 1e-8)

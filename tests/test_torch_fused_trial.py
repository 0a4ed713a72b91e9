"""Port parity: the fused-trial grid step (``make_grid_step(fuse_trial=True)``,
``init_grid_state_fused``, ``solve_ba_grid(fuse_trial=True)``).

Tolerances:
  * against the reference's fused step on its kernel path
    (``impl="pallas"``, interpret mode), two steps on the monolithic and
    the banded route: the same accept decisions, cost rtol 1e-6, points
    and camera vector rtol 1e-5 / atol 1e-8 (tests/test_torch_rig_grid.py's,
    the kernels' f32-free sums in another order);
  * against the port's classic step, four steps from one start: start cost
    rtol 1e-12, step costs rtol 1e-10, points and camera vector rtol 1e-8 /
    atol 1e-12 (the reference's own test of its fused step,
    tests/test_rig_grid.py:202-234: the fused costs come from the linearize
    kernel, the classic ones from the cost kernel);
  * solves: ``driver="while_loop"`` gives the Python driver's bits; against
    the reference's ``solve_ba_grid(fuse_trial=True, impl="planes")`` the
    same iterations, cost rtol 1e-9, points and camera vector rtol 1e-5 /
    atol 1e-8 (tests/test_torch_device_loop.py's grid tolerances);
  * a solve resumed from a checkpoint taken mid-solve ends on the
    uninterrupted solve's bits (the resume linearizes at the checkpoint's
    iterate, which is the system the uninterrupted solve carries there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.config import SolverOptions as JSolverOptions
from deeparc_tpu.io import make_hemisphere_rig
from deeparc_tpu.residuals.reprojection import flatten_camera as jflatten
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver import rig_grid as jrg
from deeparc_tpu.solver.rig_band import band_grid as jband_grid
from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.residuals.reprojection import flatten_camera
from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
from deeparc_tpu_torch.solver import rig_grid as trg
from torch_parity import close, grid_to_torch, params_to_torch

OPTIONS = dict(linear_solver="dense_schur")
# the band prep declines a 3x5-cell rig: the monolithic kernels
MONO_RIG = dict(n_arc=3, n_ring=5, n_points=50, pixel_noise=0.5,
                point_noise=0.04, visibility=0.8, seed=31)
# the band prep takes it (tests/test_torch_rig_grid.py _solve_inputs)
BANDED_RIG = dict(n_arc=3, n_ring=16, n_points=300, occlusion_rings=4,
                  visibility=0.9, pixel_noise=0.8, point_noise=0.02, seed=7)
# no convergence test stops these solves before max_iterations
RUN_ON = dict(function_tolerance=0.0, parameter_tolerance=0.0,
              gradient_tolerance=0.0)


def _mono_problem():
    scene = jfrom_deeparc(make_hemisphere_rig(**MONO_RIG).data)
    free = jfreeze(scene)
    return (scene.params, jrg.grid_from_scene(scene), np.asarray(
        jflatten(free)), np.asarray(free.points), {})


def _banded_problem():
    """The banded route with the intrinsics frozen (the reference's BA
    mode): the prep's grid, points in its order."""
    scene = jfrom_deeparc(make_hemisphere_rig(**BANDED_RIG).data)
    prep = jband_grid(jrg.grid_from_scene(scene), block_np=64,
                      cost_block_np=128)
    params = dataclasses.replace(
        scene.params, points=scene.params.points[np.asarray(prep.perm)])
    R = params.ext_rot.shape[0]
    cam_free = np.ones(6 * (R + params.center.shape[0]))
    cam_free[:6] = 0.0                      # gauge extrinsic
    cam_free[6 * R:] = 0.0                  # intrinsics frozen
    bws, bbs = prep.widths
    return (params, prep.grid, cam_free, np.ones(np.asarray(
        params.points).shape), dict(band_widths=bws, band_blocks=bbs,
                                    band_intr_frozen=True))


def _torch_grid(grid):
    tg = grid_to_torch(grid)
    if grid.band:
        t = lambda a: torch.as_tensor(np.array(a))
        b = grid.band
        tg.band = (t(b[0]), t(b[1]), tuple(t(p) for p in b[2]),
                   tuple(t(p) for p in b[3]))
    return tg


def _steps_jax(params, grid, cam_free, point_free, kw, n):
    opts = JSolverOptions(**OPTIONS)
    step = jax.jit(jrg.make_grid_step(opts, params, chunk_size=32,
                                      impl="pallas", fuse_trial=True, **kw))
    state = jrg.init_grid_state_fused(
        params, grid, opts, jnp.asarray(cam_free), jnp.asarray(point_free),
        impl="pallas", chunk_size=32, **kw)
    accepts = []
    for _ in range(n):
        state, info = step(state, grid, jnp.asarray(cam_free),
                           jnp.asarray(point_free))
        accepts.append(bool(info.accepted))
    return state, accepts


def _steps_torch(params, grid, cam_free, point_free, kw, n, fuse_trial):
    opts = SolverOptions(**OPTIONS)
    cam_free, point_free = torch.tensor(cam_free), torch.tensor(point_free)
    step = trg.make_grid_step(opts, params, chunk_size=32,
                              fuse_trial=fuse_trial, **kw)
    widths = {k: v for k, v in kw.items() if k != "band_intr_frozen"}
    if fuse_trial:
        state = trg.init_grid_state_fused(params, grid, opts, cam_free,
                                          point_free, 32, **kw)
    else:
        state = trg.init_grid_state(params, grid, opts, **widths)
    states, infos = [state], []
    for _ in range(n):
        state, info = step(state, grid, cam_free, point_free)
        states.append(state)
        infos.append(info)
    return states, infos


PROBLEMS = {"monolithic": _mono_problem, "banded": _banded_problem}


@pytest.fixture(scope="module", params=sorted(PROBLEMS))
def problem(request):
    params, grid, cam_free, point_free, kw = PROBLEMS[request.param]()
    return (request.param, params, grid, params_to_torch(params),
            _torch_grid(grid), cam_free, point_free, kw)


def test_fused_steps_match_jax(problem):
    _, params, grid, tparams, tgrid, cam_free, point_free, kw = problem
    want, accepts = _steps_jax(params, grid, cam_free, point_free, kw, 2)
    states, infos = _steps_torch(tparams, tgrid, cam_free, point_free, kw, 2,
                                 fuse_trial=True)
    got = states[-1]
    assert [bool(i.accepted) for i in infos] == accepts
    close(got.cost, want.cost, 1e-6)
    close(got.sys.cost, want.sys.cost, 1e-6)
    close(got.points, want.points, 1e-5, 1e-8)
    close(got.cam_vec, want.cam_vec, 1e-5, 1e-8)


def test_fused_steps_match_the_classic_steps(problem):
    _, _, _, tparams, tgrid, cam_free, point_free, kw = problem
    fused, info_f = _steps_torch(tparams, tgrid, cam_free, point_free, kw, 4,
                                 fuse_trial=True)
    classic, info_c = _steps_torch(tparams, tgrid, cam_free, point_free, kw,
                                   4, fuse_trial=False)
    close(fused[0].cost, classic[0].cost, 1e-12)
    for f, c, i_f, i_c in zip(fused[1:], classic[1:], info_f, info_c):
        assert bool(i_f.accepted) == bool(i_c.accepted)
        close(f.cost, c.cost, 1e-10)
    close(fused[-1].points, classic[-1].points, 1e-8, 1e-12)
    close(fused[-1].cam_vec, classic[-1].cam_vec, 1e-8, 1e-12)
    # the carried system is the linearize at the final iterate, bit for bit
    last = fused[-1]
    assert isinstance(last, trg.GridStateF)
    assert torch.equal(last.sys.cost, last.cost)
    assert sum(bool(i.accepted) for i in info_f) >= 2
    again = trg.init_grid_state_fused(
        trg._params_from(last.cam_vec, last.points, tparams), tgrid,
        SolverOptions(**OPTIONS), torch.tensor(cam_free),
        torch.tensor(point_free), 32, **kw)
    for field, a, b in zip(trg.GridSystem._fields, again.sys, last.sys):
        assert torch.equal(a, b), field


@pytest.fixture(scope="module")
def rigs():
    out = {}
    for name, kw in (("monolithic", MONO_RIG), ("banded", BANDED_RIG)):
        data = make_hemisphere_rig(**kw).data
        scene = from_deeparc(data, device="cpu")
        out[name] = (data, scene, trg.grid_from_scene(scene),
                     freeze_masks(scene))
    return out


def _solve(rigs, name, options, **kw):
    _, scene, grid, free = rigs[name]
    reuse: dict = {}
    res = trg.solve_ba_grid(scene.params, grid, free, options,
                            band_reuse=reuse, **kw)
    assert (reuse["prep"] is not None) == (name == "banded")
    return res


def _same(a, b):
    assert (a.iterations, a.status) == (b.iterations, b.status)
    assert a.cost == b.cost
    for f in dataclasses.fields(a.params):
        assert torch.equal(getattr(a.params, f.name),
                           getattr(b.params, f.name)), f.name


def test_fused_solve_under_both_drivers_matches_jax(rigs):
    """The banded route, the pipeline's; the monolithic one's steps are
    held above and its solves below."""
    name = "banded"
    opts = dict(max_iterations=5, **OPTIONS)
    py = _solve(rigs, name, SolverOptions(**opts), fuse_trial=True)
    wl = _solve(rigs, name, SolverOptions(**opts), fuse_trial=True,
                driver="while_loop", while_block=2)
    _same(wl, py)
    data = rigs[name][0]
    js = jfrom_deeparc(data)
    want = jrg.solve_ba_grid(js.params, jrg.grid_from_scene(js), jfreeze(js),
                             JSolverOptions(**opts), impl="planes",
                             chunk_size=128, fuse_trial=True)
    assert py.iterations == int(want.iterations)
    close(py.cost, float(want.cost), 1e-9)
    close(py.params.points, np.asarray(want.params.points), 1e-5, 1e-8)
    close(flatten_camera(py.params), jflatten(want.params), 1e-5, 1e-8)


def test_fuse_trial_none_is_the_classic_step(rigs):
    opts = SolverOptions(max_iterations=3, **OPTIONS)
    _same(_solve(rigs, "monolithic", opts),
          _solve(rigs, "monolithic", opts, fuse_trial=False))


@pytest.mark.parametrize("driver", ["python", "while_loop"])
def test_fused_solve_resumes_onto_the_uninterrupted_bits(rigs, driver,
                                                         tmp_path):
    path = str(tmp_path / "ck.npz")
    kw = dict(fuse_trial=True, driver=driver, while_block=2)
    opts = lambda n: SolverOptions(max_iterations=n, **OPTIONS, **RUN_ON)
    full = _solve(rigs, "monolithic", opts(6), **kw)
    first = _solve(rigs, "monolithic", opts(3), checkpoint_path=path,
                   checkpoint_every=3, **kw)
    assert first.iterations == 3
    resumed = _solve(rigs, "monolithic", opts(6), checkpoint_path=path,
                     resume=True, **kw)
    _same(resumed, full)

"""Port parity: the rotation logs, solver-state checkpoints (in both
directions between the packages), resumed solves on every engine, the
JSONL logger and the phase timers (PyTorch port on the CPU vs the JAX
package).

Tolerances: ``matrix_to_angle_axis`` / ``quaternion_to_angle_axis`` 1e-12
absolute on angles of order 1 (the same formulas in both packages), their
derivatives 1e-9; a resumed solve ends at the uninterrupted solve's cost
within 1e-12 relative (the same process and the same kernels: in practice
the same bits); a port solve resumed from the reference's checkpoint ends
within 1e-8 of the uninterrupted port solve (the reference's first three
iterations differ from the port's in the last digits)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.config import SolverOptions as JSolverOptions
from deeparc_tpu.geometry import rotation as jrot
from deeparc_tpu.io import make_hemisphere_rig
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.utils import load_solver_state as jload
from deeparc_tpu.utils import save_solver_state as jsave
from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.geometry import rotation as trot
from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
from deeparc_tpu_torch.utils import (
    JsonlLogger,
    load_solver_state,
    phase_report,
    phase_timer,
    reset_phases,
    save_solver_state,
)
from torch_parity import as_np, params_to_torch


def _angle_axes():
    """Random rotations, and the edges of every branch: angle 0 and 1e-13,
    tiny angles, angles at and near pi about each axis and a skew axis
    (each of the four quaternion cases picks), negative trace."""
    rng = np.random.default_rng(0)
    axes = np.concatenate([np.eye(3), rng.normal(size=(3, 3))])
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    edge = [a * t for a in axes for t in (0.0, 1e-13, 1e-7, 0.3, 2.5,
                                          np.pi - 1e-7, np.pi)]
    return np.concatenate([rng.normal(scale=1.0, size=(24, 3)),
                           np.asarray(edge)])


def test_matrix_to_angle_axis_matches_jax():
    R = np.asarray(jrot.angle_axis_to_matrix(jnp.asarray(_angle_axes())))
    want = np.asarray(jrot.matrix_to_angle_axis(jnp.asarray(R)))
    got = trot.matrix_to_angle_axis(torch.tensor(R))
    np.testing.assert_allclose(as_np(got), want, rtol=0, atol=1e-12)


def test_quaternion_to_angle_axis_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(32, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[:4, 1:] *= 1e-14                    # angle 0 (small branch)
    q[4:8, 0] = np.array([0.0, 1e-12, -1e-12, -0.0])   # angle pi
    q[4:8] /= np.linalg.norm(q[4:8], axis=1, keepdims=True)
    q[8:12, 0] *= -1.0                    # w < 0: folded angles
    want = np.asarray(jrot.quaternion_to_angle_axis(jnp.asarray(q)))
    got = trot.quaternion_to_angle_axis(torch.tensor(q))
    np.testing.assert_allclose(as_np(got), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("angle", [0.0, 1e-9, 0.7, np.pi - 1e-6])
def test_matrix_to_angle_axis_differentiable_like_jax(angle):
    """The derivative of the rotation log through every branch, at angle 0
    and near pi: finite and the reference's (under vmap as well)."""
    aa = np.array([0.6, -0.48, 0.64]) * angle
    R = np.asarray(jrot.angle_axis_to_matrix(jnp.asarray(aa)))
    want = np.asarray(jax.jacfwd(jrot.matrix_to_angle_axis)(jnp.asarray(R)))
    f = trot.matrix_to_angle_axis
    got = torch.func.vmap(torch.func.jacfwd(f))(torch.tensor(R)[None])[0]
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(as_np(got), want, rtol=1e-9, atol=1e-9)


def _problem():
    rig = make_hemisphere_rig(n_arc=3, n_ring=4, n_points=30,
                              point_noise=0.05, pixel_noise=0.4, seed=31)
    return rig.data


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    """A solver-state .npz written by either package loads in the other
    with the same keys and values."""
    jscene = jfrom_deeparc(_problem())
    path = str(tmp_path / "state.npz")
    if writer == "jax":
        jsave(path, jscene.params, 123.0, 4.0, 7, 55.5)
        params, scal = load_solver_state(path, device="cpu")
        want = jscene.params
    else:
        save_solver_state(path, params_to_torch(jscene.params), 123.0, 4.0,
                          7, 55.5)
        params, scal = jload(path)
        want = jscene.params
    assert scal == {"radius": 123.0, "decrease_factor": 4.0, "iteration": 7,
                    "cost": 55.5}
    for name in ("points", "ext_rot", "ext_trans", "center", "focal",
                 "dist"):
        np.testing.assert_array_equal(as_np(getattr(params, name)),
                                      np.asarray(getattr(want, name)))
    assert set(np.load(path).files) == {
        "points", "ext_rot", "ext_trans", "center", "focal", "dist",
        "radius", "decrease_factor", "iteration", "cost"}


def _solvers(data):
    """engine -> (port solve(options, **kw), reference solve(options, **kw))."""
    from deeparc_tpu.solver.ba import solve_ba as jsolve_ba
    from deeparc_tpu.solver.rig_grid import grid_from_scene as jgrid_from
    from deeparc_tpu.solver.rig_grid import solve_ba_grid as jsolve_grid
    from deeparc_tpu.solver.tiles import solve_ba_tiles as jsolve_tiles
    from deeparc_tpu_torch.solver.ba import solve_ba
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene, solve_ba_grid
    from deeparc_tpu_torch.solver.tiles import solve_ba_tiles

    scene = from_deeparc(data, device="cpu")
    free = freeze_masks(scene)
    grid = grid_from_scene(scene)
    js = jfrom_deeparc(data)
    jfree = jfreeze(js)
    jgrid = jgrid_from(js)
    return {
        "solve_ba": (
            lambda o, **kw: solve_ba(scene.params, scene.index, free, o, **kw),
            lambda o, **kw: jsolve_ba(js.params, js.index, jfree, o, **kw)),
        "solve_ba_grid": (
            lambda o, **kw: solve_ba_grid(scene.params, grid, free, o, **kw),
            lambda o, **kw: jsolve_grid(js.params, jgrid, jfree, o,
                                        chunk_size=16, **kw)),
        "solve_ba_tiles": (
            lambda o, **kw: solve_ba_tiles(scene, free, o, chunk_obs=16,
                                           **kw),
            lambda o, **kw: jsolve_tiles(js, jfree, o, chunk_obs=16, **kw)),
    }


@pytest.mark.parametrize("engine", ["solve_ba", "solve_ba_grid",
                                    "solve_ba_tiles"])
def test_resumed_solve_ends_where_the_uninterrupted_one_ends(tmp_path,
                                                             engine):
    """Pattern of tests/test_utils.py: a solve stopped after 3 iterations
    (checkpoint every 3, a JSONL log) and resumed to 6 ends where the
    uninterrupted 6-iteration solve ends; the checkpoint holds points in
    their original order; a port solve resumed from the reference's
    checkpoint ends there too."""
    solve, jsolve = _solvers(_problem())[engine]
    path, jpath = str(tmp_path / "ck.npz"), str(tmp_path / "ck_jax.npz")
    log_path = str(tmp_path / "log.jsonl")
    full = solve(SolverOptions(max_iterations=6))
    with JsonlLogger(log_path) as logger:
        first = solve(SolverOptions(max_iterations=3), checkpoint_path=path,
                      checkpoint_every=3, logger=logger)
    records = [json.loads(line) for line in open(log_path)]
    assert len(records) == first.iterations == 3
    assert all(r["event"] == "lm_iteration" for r in records)
    ck_params, scal = load_solver_state(path, device="cpu")
    assert ck_params.points.shape == full.params.points.shape
    assert scal["iteration"] == 3
    resumed = solve(SolverOptions(max_iterations=6), checkpoint_path=path,
                    checkpoint_every=100, resume=True)
    assert resumed.iterations == full.iterations
    np.testing.assert_allclose(resumed.cost, full.cost, rtol=1e-12)
    np.testing.assert_allclose(as_np(resumed.params.points),
                               as_np(full.params.points), rtol=1e-12,
                               atol=1e-12)

    jsolve(JSolverOptions(max_iterations=3), checkpoint_path=jpath,
           checkpoint_every=3)
    from_ref = solve(SolverOptions(max_iterations=6), checkpoint_path=jpath,
                     resume=True)
    assert from_ref.iterations == full.iterations
    np.testing.assert_allclose(from_ref.cost, full.cost, rtol=1e-8)


def test_jsonl_logger_lines(tmp_path):
    """Pattern of tests/test_utils.py: one ``lm_iteration`` line a step with
    the reference's fields; accepted costs never rise."""
    from deeparc_tpu_torch.solver.ba import solve_ba

    scene = from_deeparc(_problem(), device="cpu")
    path = str(tmp_path / "log.jsonl")
    with JsonlLogger(path) as logger:
        res = solve_ba(scene.params, scene.index, freeze_masks(scene),
                       SolverOptions(max_iterations=4), logger=logger)
    records = [json.loads(line) for line in open(path)]
    assert len(records) == res.iterations
    assert all(r["event"] == "lm_iteration" for r in records)
    assert set(records[0]) >= {"t", "iter", "cost", "cost_change",
                               "grad_max", "step_norm", "radius", "rho",
                               "accepted"}
    costs = [r["cost"] for r in records if r["accepted"]]
    assert costs == sorted(costs, reverse=True)
    JsonlLogger(None).log("lm_iteration", iter=1)     # no path: no file


def test_phase_timer():
    reset_phases()
    sink: dict = {}
    with phase_timer("stage_a", sink):
        pass
    with phase_timer("stage_a", sink, device="cpu"):
        pass
    rep = phase_report()
    assert rep["stage_a"]["count"] == 2
    assert sink["stage_a"] == pytest.approx(rep["stage_a"]["total_s"])
    reset_phases()
    assert phase_report() == {}


def _degenerate(scene):
    """The scene's parameters with point 0 on camera (0, 0)'s z = 0 plane
    (that camera's frame is the world frame): the unguarded perspective
    divide, ``src/snavely_reprojection_error.hh:49-50``."""
    import dataclasses

    pts = scene.params.points.clone()
    pts[0] = torch.tensor([0.3, 0.3, 0.0], dtype=pts.dtype)
    return dataclasses.replace(scene.params, points=pts)


def test_nan_debugging_fails_loudly_on_degenerate_point():
    """tests/test_utils.py:90-118 on the port: under the toggle the
    residuals raise, naming the operator that made the NaN; the toggle
    restored, the same call gives NaNs silently."""
    from deeparc_tpu_torch.residuals.reprojection import residuals
    from deeparc_tpu_torch.utils.debug import nan_debugging

    scene = from_deeparc(_problem(), device="cpu")
    bad = _degenerate(scene)
    with nan_debugging(True):
        with pytest.raises(FloatingPointError,
                           match=r"reprojection\.residuals: first produced "
                                 r"by aten\.\w+"):
            residuals(bad, scene.index)
    r = residuals(bad, scene.index)
    assert not bool(torch.isfinite(r).all())


@pytest.mark.parametrize("engine, driver, where", [
    ("grid", "python", "the grid LM step of iteration 1"),
    ("grid", "while_loop", "the grid LM step of iteration 1 "
                           "(driver='while_loop')"),
    ("tiles", "python", "the tiles LM step of iteration 1"),
    # ITERATIVE_SCHUR: the step's PCG is a device loop, re-run in its plain
    # form
    ("tiles", "while_loop", "the tiles LM step of iteration 1 "
                            "(driver='while_loop')"),
    # the start cost is the indexed solve's first checked boundary
    ("indexed", "python", "reprojection.residuals"),
])
def test_nan_debugging_names_the_engine_and_iteration(engine, driver, where):
    """A degenerate point in each engine's solve: on, FloatingPointError
    naming the engine's step (or boundary), the iteration and an
    operator; off, the solve returns a NaN cost and raises nothing."""
    import dataclasses
    import math

    from deeparc_tpu_torch.solver.ba import solve_ba
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene, solve_ba_grid
    from deeparc_tpu_torch.solver.tiles import solve_ba_tiles
    from deeparc_tpu_torch.utils.debug import nan_debugging

    scene = from_deeparc(_problem(), device="cpu")
    free = freeze_masks(scene)
    bad = dataclasses.replace(scene, params=_degenerate(scene))
    opts = SolverOptions(max_iterations=2, progress_to_stdout=False)
    solve = {
        "grid": lambda: solve_ba_grid(bad.params, grid_from_scene(bad), free,
                                      opts, driver=driver),
        "tiles": lambda: solve_ba_tiles(
            bad, free, dataclasses.replace(opts, linear_solver=(
                "iterative_schur" if driver == "while_loop" else
                opts.linear_solver)), chunk_obs=16, driver=driver),
        "indexed": lambda: solve_ba(bad.params, bad.index, free, opts),
    }[engine]
    with nan_debugging(True):
        with pytest.raises(FloatingPointError) as err:
            solve()
    assert where in str(err.value)
    assert "first produced by aten." in str(err.value)
    assert math.isnan(solve().cost)


@pytest.mark.parametrize("driver", ["python", "while_loop"])
def test_nan_debugging_off_checks_nothing_and_changes_no_bit(driver):
    """A grid solve with the toggle off runs no check; on, it checks every
    step (or block) and ends on the same bits."""
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene, solve_ba_grid
    from deeparc_tpu_torch.utils import debug

    scene = from_deeparc(_problem(), device="cpu")
    free, grid = freeze_masks(scene), grid_from_scene(scene)
    opts = SolverOptions(max_iterations=4, progress_to_stdout=False)
    runs = {}
    for on in (False, True):
        before = debug.checks
        with debug.nan_debugging(on):
            runs[on] = (solve_ba_grid(scene.params, grid, free, opts,
                                      driver=driver, while_block=2),
                        debug.checks - before)
    (off, n_off), (on, n_on) = runs[False], runs[True]
    assert n_off == 0 and n_on >= 2
    assert off.cost == on.cost and off.iterations == on.iterations
    for name in ("points", "ext_rot", "ext_trans"):
        assert torch.equal(getattr(off.params, name), getattr(on.params, name))


def test_trace_to_writes_a_trace_naming_a_torch_operator(tmp_path):
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene, solve_ba_grid
    from deeparc_tpu_torch.utils import trace_to

    scene = from_deeparc(_problem(), device="cpu")
    free, grid = freeze_masks(scene), grid_from_scene(scene)
    with trace_to(str(tmp_path / "trace")) as prof:
        solve_ba_grid(scene.params, grid, free,
                      SolverOptions(max_iterations=2,
                                    progress_to_stdout=False))
    assert prof.trace_path.startswith(str(tmp_path / "trace"))
    with open(prof.trace_path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)


def test_cli_debug_nans_runs_to_the_end(tmp_path):
    """``python -m deeparc_tpu_torch.pipeline.cli --synthetic --device cpu
    --debug-nans`` (here in-process, smaller) runs to the end."""
    from deeparc_tpu_torch.pipeline.cli import main
    from deeparc_tpu_torch.utils import debug

    try:
        rc = main(["--synthetic", "--device", "cpu", "--debug-nans",
                   "--n-arc", "3", "--n-ring", "6", "--n-points", "300",
                   "--max-iterations", "5", "--hemisphere-iterations", "50",
                   "--no-snapshots", "--quiet", "-o", str(tmp_path)])
        assert debug.enabled()
    finally:
        debug.set_nan_debugging(False)
    assert rc == 0

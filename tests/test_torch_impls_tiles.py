"""Port parity: the tile engine's torch paths (``impl="xla"``: the chunk
linearize and the torch sweeps for every bucket) against the JAX package's
XLA path on its CPU backend in float64, and ``impl="dual"``, which the port
refuses.

Tolerances: the linearize and the sweeps 1e-10 relative; three LM steps
and a solve as the reference holds its impls against each other
(tests/test_tiles.py:298-334: cost rtol 1e-8, iterates rtol 1e-6 / atol
1e-9, the same accept decisions); the port against itself (the two
drivers) bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.config import SolverOptions as JSolverOptions
from deeparc_tpu.io.synthetic import (
    make_bal_heavytail_device,
    make_bal_synthetic,
    make_hemisphere_rig,
)
from deeparc_tpu.residuals.reprojection import camera_dim
from deeparc_tpu.residuals.reprojection import flatten_camera as jflatten
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver import rig_grid as jrg
from deeparc_tpu.solver import tiles as jt
from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.solver import rig_grid as trg
from deeparc_tpu_torch.solver import tiles as tt
from deeparc_tpu_torch.solver.linalg import inv3x3
from torch_parity import close, params_to_torch, tiles_to_torch

CHUNK = 256  # tests/test_tiles.py's: every bucket spans 2+ chunks
STEP_OPTS = dict(linear_solver="iterative_schur", cg_max_iterations=40,
                 min_relative_decrease=-1.0, function_tolerance=0.0,
                 gradient_tolerance=0.0, parameter_tolerance=0.0)


def _scene_problem(kind):
    """tests/test_tiles.py's problem: a BAL scene or a rig, laid out by
    the reference."""
    if kind == "bal":
        data = make_bal_synthetic(n_cameras=12, n_points=150,
                                  track_length=5.0, pixel_noise=0.5,
                                  point_noise=0.03, seed=3).data
    else:
        data = make_hemisphere_rig(n_arc=3, n_ring=5, n_points=80,
                                   pixel_noise=0.5, point_noise=0.03,
                                   visibility=0.7, seed=3).data
    scene = jfrom_deeparc(data)
    free = jfreeze(scene)
    tiles, params_t, free_t = jt.tiles_from_scene(scene, free,
                                                  chunk_obs=CHUNK)
    return tiles, params_t, free_t, jflatten(free)


def _heavytail_problem():
    """Several width buckets (test_heavytail.py's generator)."""
    params, tiles, _, cam_free = make_bal_heavytail_device(
        n_cameras=32, n_points=200, mean_track=5.0, sigma=0.8,
        max_track=32, window=16, chunk_obs=256, pixel_noise=0.5,
        point_noise=0.03, seed=3, dtype=jnp.float64)
    return tiles, params, jnp.ones_like(params.points), cam_free


@pytest.fixture(scope="module", params=["bal", "rig", "heavytail"])
def problem(request):
    if request.param == "heavytail":
        jtiles, jparams, jfree_t, jcam_free = _heavytail_problem()
    else:
        jtiles, jparams, jfree_t, jcam_free = _scene_problem(request.param)
    C = camera_dim(jparams)
    return dict(
        name=request.param, jtiles=jtiles, jparams=jparams, jfree_t=jfree_t,
        jcam_free=jcam_free, C=C, tiles=tiles_to_torch(jtiles, C),
        params=params_to_torch(jparams),
        free_t=torch.as_tensor(np.array(jfree_t)),
        cam_free=torch.as_tensor(np.array(jcam_free)))


def _systems(p):
    """Both packages' chunk-path systems on the problem, and a B^-1."""
    jpacked = jt.pack_cells(jrg.slot_params(p["jparams"], p["jtiles"].cells),
                            p["jtiles"].cells, p["jcam_free"])
    packed = tt.pack_cells(trg.slot_params(p["params"], p["tiles"].cells),
                           p["tiles"].cells, p["cam_free"])
    jsys = jax.jit(lambda *a: jt.linearize_tiles(*a, p["C"], CHUNK))(
        p["jparams"].points, jpacked, p["jtiles"], p["jfree_t"])
    sys = tt.linearize_tiles(p["params"].points, packed, p["tiles"],
                             p["free_t"], p["C"])
    eye = np.eye(3)
    jbinv = jrg.inv3x3(jsys.hpp + jnp.asarray(eye))
    binv = inv3x3(sys.hpp + torch.as_tensor(eye))
    return jsys, jbinv, sys, binv


def test_xla_linearize_and_sweeps_match_jax(problem):
    """The chunk linearize, the rhs and matvec sweeps and edot of the
    torch path against the reference's XLA bodies."""
    jtiles, tiles = problem["jtiles"], problem["tiles"]
    jsys, jbinv, sys, binv = _systems(problem)
    close(sys.cost, jsys.cost, 1e-12)
    for name in ("g_p", "hpp", "g_c", "hcc_cells", "hcc_diag"):
        close(getattr(sys, name), getattr(jsys, name), 1e-10, 1e-12)
    V = tiles.cells.cols.shape[0]
    v = np.random.default_rng(4).normal(size=(V, 18))
    jv, tv = jnp.asarray(v), torch.as_tensor(v)
    jsweep = jax.jit(lambda *a: jt._e_sweep(*a, chunk_obs=CHUNK),
                     static_argnums=4)
    close(tt._e_sweep(tiles, sys, binv, None, True),
          jsweep(jtiles, jsys, jbinv, None, True), 1e-10, 1e-12)
    close(tt._e_sweep(tiles, sys, binv, tv, False),
          jsweep(jtiles, jsys, jbinv, jv, False), 1e-10, 1e-12)
    close(tt._e_dot_cells(tiles, sys, tv),
          jax.jit(lambda *a: jt._e_dot_cells(*a, chunk_obs=CHUNK))(
              jtiles, jsys, jv), 1e-10, 1e-12)


def test_xla_steps_match_jax(problem):
    p = problem
    jopts, opts = JSolverOptions(**STEP_OPTS), SolverOptions(**STEP_OPTS)
    jstep = jax.jit(jt.make_tile_step(jopts, p["jparams"], chunk_obs=CHUNK,
                                      impl="xla"))
    step = tt.make_tile_step(opts, p["params"], impl="xla")
    js = jt.init_tile_state(p["jparams"], p["jtiles"], jopts, p["jcam_free"],
                            chunk_obs=CHUNK)
    s = tt.init_tile_state(p["params"], p["tiles"], opts, p["cam_free"])
    for _ in range(3):
        js, jinfo = jstep(js, p["jtiles"], p["jcam_free"], p["jfree_t"])
        s, info = step(s, p["tiles"], p["cam_free"], p["free_t"])
        close(s.cost, js.cost, 1e-8)
        assert bool(info.accepted) == bool(jinfo.accepted)
    close(s.points, js.points, 1e-6, 1e-9)
    close(s.cam_vec, js.cam_vec, 1e-6, 1e-9)


def test_dual_and_unknown_impls_raise(problem):
    """``impl="dual"`` is refused on one device and sharded, before any
    work; an impl the tile engine lacks too."""
    from deeparc_tpu_torch.parallel.sharded_tiles import (
        solve_ba_tiles_sharded,
    )

    p = problem
    opts = SolverOptions(**STEP_OPTS)
    with pytest.raises(ValueError, match="not ported"):
        tt.make_tile_step(opts, p["params"], impl="dual")
    with pytest.raises(ValueError, match="not ported"):
        tt.solve_tiles_prepared(p["params"], p["tiles"], p["free_t"],
                                p["cam_free"], opts, impl="dual")
    with pytest.raises(ValueError, match="not ported"):
        solve_ba_tiles_sharded(p["params"], p["tiles"], p["free_t"],
                               p["cam_free"], impl="dual")
    with pytest.raises(ValueError, match="unknown tile impl"):
        tt.make_tile_step(opts, p["params"], impl="planes")


def test_while_loop_gives_the_python_drivers_bits(problem):
    p = problem
    opts = SolverOptions(max_iterations=3, linear_solver="iterative_schur",
                         cg_max_iterations=40, cg_tolerance=1e-3)
    run = lambda **kw: tt.solve_tiles_prepared(
        p["params"], p["tiles"], p["free_t"], p["cam_free"], opts,
        impl="xla", **kw)
    py, wl = run(), run(driver="while_loop", while_block=2)
    assert (wl.iterations, wl.status, wl.cg_iterations) == (
        py.iterations, py.status, py.cg_iterations)
    assert wl.cost == py.cost
    for f in dataclasses.fields(py.params):
        assert torch.equal(getattr(wl.params, f.name),
                           getattr(py.params, f.name)), f.name


def test_solve_ba_tiles_xla_matches_jax():
    data = make_bal_synthetic(n_cameras=12, n_points=150, track_length=5.0,
                              pixel_noise=0.5, point_noise=0.03, seed=3).data
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc

    jscene = jfrom_deeparc(data)
    scene = from_deeparc(data, device="cpu")
    kw = dict(max_iterations=4, linear_solver="iterative_schur",
              cg_max_iterations=40)
    want = jt.solve_ba_tiles(jscene, jfreeze(jscene), JSolverOptions(**kw),
                             chunk_obs=CHUNK, impl="xla")
    got = tt.solve_ba_tiles(scene, freeze_masks(scene), SolverOptions(**kw),
                            chunk_obs=CHUNK, impl="xla")
    assert got.iterations == want.iterations
    close(got.cost, want.cost, 1e-8)
    close(got.params.points, want.params.points, 1e-6, 1e-9)


def test_dual_sweeps_script_matches_jax(problem):
    """``scripts/dual_sweeps.py``, which times the reference's dual sweeps
    on the card: its camera-major layout is the reference's bit for bit
    (max_width 16 splits the busiest cells across rows), its binning,
    sweeps and edot the reference's within 1e-10."""
    from deeparc_tpu_torch.scripts import dual_sweeps as ds

    p = problem
    jtiles = jt.with_cam_layout(p["jtiles"], max_width=16)
    layout = ds.cam_layout(p["tiles"], max_width=16)
    want = jtiles.cam[0]
    assert len(layout[0]) == len(want.buckets)
    for (cell, idx, _), w in zip(layout[0], want.buckets):
        np.testing.assert_array_equal(cell.numpy(), np.asarray(w.row_cell))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(w.slot_idx))
    np.testing.assert_array_equal(layout[1].numpy(), np.asarray(want.pm_src))
    rc = np.concatenate([np.asarray(b.row_cell) for b in want.buckets])
    assert np.bincount(rc).max() > 1           # a cell split across rows

    jsys, jbinv, sys, binv = _systems(p)
    V = p["tiles"].cells.cols.shape[0]
    jcms = jax.jit(jt._dual_prep)(jtiles, jsys)
    cms = ds.dual_prep(layout, sys)
    jg, jh = jax.jit(jt._dual_bin_system, static_argnums=3)(
        jtiles, jsys, jcms, V)
    g, h = ds.dual_bin_system(layout, sys, cms, V)
    close(g, jg, 1e-10, 1e-12)
    close(tt._sym_unpack(h), jh, 1e-10, 1e-12)
    v = np.random.default_rng(4).normal(size=(V, 18))
    jv, tv = jnp.asarray(v), torch.as_tensor(v)
    jsweep = jax.jit(jt._dual_sweep, static_argnums=5)
    close(ds.dual_sweep(layout, sys, binv, cms, None, True),
          jsweep(jtiles, jsys, jbinv, jcms, None, True), 1e-10, 1e-12)
    close(ds.dual_sweep(layout, sys, binv, cms, tv, False),
          jsweep(jtiles, jsys, jbinv, jcms, jv, False), 1e-10, 1e-12)
    close(ds.dual_edot(layout, sys, cms, tv),
          jax.jit(jt._dual_edot)(jtiles, jsys, jcms, jv), 1e-10, 1e-12)


def test_dual_sweeps_script_runs_on_the_cpu(capsys):
    """The script end to end at a small size on the plain versions: the
    dual sweeps agree with the kernel path's (it raises otherwise)."""
    import json

    from deeparc_tpu_torch.scripts import dual_sweeps as ds

    assert ds.main(["--device", "cpu", "--n-points", "3000"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["platform"] == "cpu"
    assert max(out["rel_err_to_kernels"].values()) <= ds.RTOL
    assert out["camera_major_slots"] >= out["live_slots"] > 0

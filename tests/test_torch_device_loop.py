"""Port parity: the on-device LM driver (``driver="while_loop"``,
``while_block``) of the grid, tile and indexed engines, and the device form
of PCG, on the CPU (their plain forms: the same programs, run eagerly).

Against the port's own ``driver="python"``: the same bits (points, camera
vector, cost, iterations, status, PCG iterations), since both drivers run
the same ops in the same order. Against the reference's
``driver="while_loop"``: the same iterations, cost rtol 1e-9, points and
camera vector within the tolerances of the engines' existing parity tests
(grid rtol 1e-5 / atol 1e-8 against the reference's ``impl="planes"``,
tests/test_torch_rig_grid.py; tiles rtol 1e-7 / atol 1e-10,
tests/test_torch_tiles.py). The reference's own driver tests are mirrored:
a zero time budget runs no iteration (tests/test_utils.py:167-175), a
solve that converges inside a block stops there (tests/test_rig_grid.py:
168, tests/test_solver.py:224, tests/test_tiles.py:123), a
``max_iterations`` that is no multiple of ``while_block``, and the
checkpoint written after every block, from which a resumed solve ends on
the uninterrupted solve's bits."""

import dataclasses

import numpy as np
import pytest
import torch

from deeparc_tpu.config import SolverOptions as JSolverOptions
from deeparc_tpu.io import make_hemisphere_rig
from deeparc_tpu.io.synthetic import make_bal_synthetic
from deeparc_tpu.residuals.reprojection import flatten_camera as jflatten
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver import rig_grid as jrg
from deeparc_tpu.solver import tiles as jt
from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.kernels import graph_loop
from deeparc_tpu_torch.residuals.reprojection import flatten_camera
from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
from deeparc_tpu_torch.solver import ba as tba
from deeparc_tpu_torch.solver import rig_grid as trg
from deeparc_tpu_torch.solver import tiles as tt
from deeparc_tpu_torch.solver.ba import solve_ba
from deeparc_tpu_torch.solver.linalg import pcg, pcg_device
from torch_parity import close

GRID_RIGS = {
    # the band prep takes it (tests/test_torch_rig_grid.py _solve_inputs)
    "banded": dict(n_arc=3, n_ring=16, n_points=300, occlusion_rings=4,
                   visibility=0.9, pixel_noise=0.8, point_noise=0.02,
                   seed=7),
    # the band prep declines a 3x5-cell rig: the monolithic kernels
    "monolithic": dict(n_arc=3, n_ring=5, n_points=50, pixel_noise=0.5,
                       point_noise=0.04, visibility=0.8, seed=31),
}
TILE_OPTS = dict(linear_solver="iterative_schur", cg_max_iterations=60,
                 cg_tolerance=1e-3)
# no convergence test stops these solves before max_iterations
RUN_ON = dict(function_tolerance=0.0, parameter_tolerance=0.0,
              gradient_tolerance=0.0)


def _same(a, b):
    """Two BAResults hold the same bits."""
    assert (a.iterations, a.status, a.cg_iterations) == (
        b.iterations, b.status, b.cg_iterations)
    assert a.cost == b.cost
    for f in dataclasses.fields(a.params):
        assert torch.equal(getattr(a.params, f.name),
                           getattr(b.params, f.name)), f.name


@pytest.fixture(scope="module")
def grids():
    out = {}
    for name, kw in GRID_RIGS.items():
        data = make_hemisphere_rig(**kw).data
        scene = from_deeparc(data, device="cpu")
        out[name] = (data, scene, trg.grid_from_scene(scene),
                     freeze_masks(scene))
    return out


@pytest.fixture(scope="module")
def bal():
    data = make_bal_synthetic(n_cameras=12, n_points=150, track_length=5.0,
                              pixel_noise=0.5, point_noise=0.03,
                              seed=3).data
    scene = from_deeparc(data, device="cpu")
    return data, scene, freeze_masks(scene)


@pytest.fixture(scope="module")
def indexed():
    data = make_hemisphere_rig(n_arc=3, n_ring=5, n_points=56,
                               pixel_noise=0.5, point_noise=0.04,
                               seed=6).data
    scene = from_deeparc(data, device="cpu")
    return scene, freeze_masks(scene, optimize_intrinsics=True)


def _grid_solve(grids, name, driver, **kw):
    _, scene, grid, free = grids[name]
    reuse: dict = {}
    opts = kw.pop("options", SolverOptions(max_iterations=5, **RUN_ON))
    res = trg.solve_ba_grid(scene.params, grid, free, opts, driver=driver,
                            band_reuse=reuse, **kw)
    assert (reuse["prep"] is not None) == (name == "banded")
    return res


@pytest.mark.parametrize("tol,max_it", [(1e-10, 500), (1e-3, 500),
                                        (1e-10, 7)])
def test_pcg_device_form_matches_host_form(tol, max_it):
    """The device form (its WHILE loop in the plain form on the CPU)
    gives the host-checked loop's iterates and count bit for bit."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(40, 40))
    A = torch.tensor(A @ A.T + 4 * np.eye(40))
    b = torch.tensor(rng.normal(size=40))
    d = 1.0 / torch.diagonal(A)
    host = pcg(lambda v: A @ v, b, lambda v: d * v, max_it, tol)
    dev = pcg_device(lambda v: A @ v, b, lambda v: d * v, max_it, tol)
    assert isinstance(dev.iterations, torch.Tensor)
    assert int(dev.iterations) == host.iterations > 0
    assert torch.equal(dev.x, host.x)
    assert torch.equal(dev.residual_norm, host.residual_norm)


def test_while_loop_plain_form_and_its_card_guard():
    """On CPU tensors the WHILE loop is a Python loop over the flag; a
    body that never runs leaves the state as it was."""
    k = torch.zeros((), dtype=torch.int64)
    graph_loop.while_loop(lambda: k < 3, lambda: k.add_(1))
    assert int(k) == 3
    graph_loop.while_loop(lambda: k < 3, lambda: k.add_(1))
    assert int(k) == 3
    with pytest.raises(TypeError, match="one bool"):
        graph_loop.while_loop(lambda: k, lambda: None)


@pytest.mark.parametrize("name", sorted(GRID_RIGS))
def test_grid_while_loop_gives_the_python_drivers_bits(grids, name, capsys):
    py = _grid_solve(grids, name, "python")
    capsys.readouterr()
    wl = _grid_solve(grids, name, "while_loop", while_block=2)
    _same(wl, py)
    assert wl.iterations == 5
    # no per-iteration progress lines in this mode
    assert "cost_change" not in capsys.readouterr().out


@pytest.mark.parametrize("locality", [True, False])
def test_tiles_while_loop_gives_the_python_drivers_bits(bal, locality):
    _, scene, free = bal
    opts = SolverOptions(max_iterations=4, **TILE_OPTS, **RUN_ON)
    py = tt.solve_ba_tiles(scene, free, opts, chunk_obs=256,
                           locality=locality)
    wl = tt.solve_ba_tiles(scene, free, opts, chunk_obs=256,
                           locality=locality, driver="while_loop",
                           while_block=2)
    _same(wl, py)
    # the loose tolerance stops PCG early
    assert 0 < py.cg_iterations < py.iterations * TILE_OPTS[
        "cg_max_iterations"]


@pytest.mark.parametrize("solver", ["dense_schur", "iterative_schur"])
def test_indexed_while_loop_gives_the_python_drivers_bits(indexed, solver):
    scene, free = indexed
    opts = SolverOptions(max_iterations=5, linear_solver=solver,
                         cg_tolerance=1e-4)
    py = solve_ba(scene.params, scene.index, free, opts)
    wl = solve_ba(scene.params, scene.index, free, opts, driver="while_loop")
    _same(wl, py)


def test_grid_while_loop_matches_jax(grids):
    """The banded route against the reference's planes impl, both with
    ``driver="while_loop"`` in blocks of 2."""
    data = grids["banded"][0]
    js = jfrom_deeparc(data)
    opts = dict(linear_solver="dense_schur", max_iterations=5)
    want = jrg.solve_ba_grid(js.params, jrg.grid_from_scene(js), jfreeze(js),
                             JSolverOptions(**opts), impl="planes",
                             chunk_size=128, driver="while_loop",
                             while_block=2)
    got = _grid_solve(grids, "banded", "while_loop", while_block=2,
                      options=SolverOptions(**opts))
    assert got.iterations == want.iterations
    close(got.cost, float(want.cost), 1e-9)
    close(got.params.points, np.asarray(want.params.points), 1e-5, 1e-8)
    close(flatten_camera(got.params), jflatten(want.params), 1e-5, 1e-8)


def test_tiles_while_loop_matches_jax(bal):
    data, scene, free = bal
    opts = dict(max_iterations=4, linear_solver="iterative_schur",
                cg_max_iterations=20, cg_tolerance=1e-14)
    js = jfrom_deeparc(data)
    want = jt.solve_ba_tiles(js, jfreeze(js), JSolverOptions(**opts),
                             chunk_obs=256, driver="while_loop",
                             while_block=2)
    got = tt.solve_ba_tiles(scene, free, SolverOptions(**opts),
                            chunk_obs=256, driver="while_loop",
                            while_block=2)
    assert got.iterations == int(want.iterations)
    close(got.cost, float(want.cost), 1e-9)
    close(got.params.points, np.asarray(want.params.points), 1e-7, 1e-10)
    close(flatten_camera(got.params), jflatten(want.params), 1e-7, 1e-10)


# the indexed engine's while_loop driver runs the whole solve as one block,
# with no wall-clock cap (as the reference's)
@pytest.mark.parametrize("engine,driver", [
    ("grid", "python"), ("grid", "while_loop"), ("tiles", "python"),
    ("tiles", "while_loop"), ("indexed", "python")])
def test_zero_time_budget_runs_no_iteration(grids, bal, indexed, engine,
                                            driver):
    opts = SolverOptions(max_iterations=100, max_seconds=0.0)
    blocks = dict(while_block=2) if driver == "while_loop" else {}
    if engine == "grid":
        out = _grid_solve(grids, "monolithic", driver, options=opts,
                          **blocks)
    elif engine == "tiles":
        _, scene, free = bal
        out = tt.solve_ba_tiles(scene, free, dataclasses.replace(
            opts, **TILE_OPTS), chunk_obs=256, driver=driver, **blocks)
    else:
        scene, free = indexed
        out = solve_ba(scene.params, scene.index, free, opts, driver=driver)
    assert out.iterations == 0 and out.cg_iterations == 0
    assert out.status == 0


def test_a_solve_that_converges_inside_a_block_stops_there(grids):
    """A function tolerance that stops the solve after a few steps: the
    block ends at the converged step (iterations not a multiple of the
    block), as the Python driver does."""
    opts = SolverOptions(max_iterations=50, function_tolerance=1e-3)
    py = _grid_solve(grids, "monolithic", "python", options=opts)
    assert py.status == 2 and py.iterations % 4 != 0
    wl = _grid_solve(grids, "monolithic", "while_loop", while_block=4,
                     options=opts)
    _same(wl, py)


@pytest.mark.parametrize("engine", ["grid", "tiles"])
def test_max_iterations_need_not_be_a_multiple_of_the_block(grids, bal,
                                                           engine):
    if engine == "grid":
        solve = lambda driver, **kw: _grid_solve(
            grids, "banded", driver,
            options=SolverOptions(max_iterations=5, **RUN_ON), **kw)
    else:
        _, scene, free = bal
        solve = lambda driver, **kw: tt.solve_ba_tiles(
            scene, free,
            SolverOptions(max_iterations=5, **TILE_OPTS, **RUN_ON),
            chunk_obs=256, driver=driver, **kw)
    py = solve("python")
    for block in (2, 3, 7):
        wl = solve("while_loop", while_block=block)
        assert wl.iterations == 5
        _same(wl, py)


@pytest.mark.parametrize("engine", ["grid", "tiles"])
def test_checkpoint_after_each_block_and_resume(grids, bal, engine,
                                                tmp_path, monkeypatch):
    """With ``checkpoint_path`` the solver state is written after every
    block (iterations 2 and 3 for 3 iterations in blocks of 2) and no
    ``lm_iteration`` line is logged; a solve resumed from it to 6
    iterations ends on the uninterrupted 6-iteration solve's bits."""
    from deeparc_tpu_torch.utils.logging import JsonlLogger

    if engine == "grid":
        _, scene, grid, free = grids["banded"]
        solve = lambda opts, **kw: trg.solve_ba_grid(
            scene.params, grid, free, opts, driver="while_loop",
            while_block=2, band_reuse={}, **kw)
        extra = RUN_ON
    else:
        _, scene, free = bal
        solve = lambda opts, **kw: tt.solve_ba_tiles(
            scene, free, opts, chunk_obs=256, driver="while_loop",
            while_block=2, **kw)
        extra = {**TILE_OPTS, **RUN_ON}
    saved = []
    save = tba.save_checkpoint
    monkeypatch.setattr(tba, "save_checkpoint",
                        lambda path, p, tr, k, cost: (saved.append(k),
                                                      save(path, p, tr, k,
                                                           cost)))
    path, log = str(tmp_path / "ck.npz"), str(tmp_path / "log.jsonl")
    full = solve(SolverOptions(max_iterations=6, **extra))
    assert full.iterations == 6 and saved == []
    with JsonlLogger(log) as logger:
        first = solve(SolverOptions(max_iterations=3, **extra),
                      checkpoint_path=path, logger=logger)
    assert first.iterations == 3 and saved == [2, 3]
    assert open(log).read() == ""
    resumed = solve(SolverOptions(max_iterations=6, **extra),
                    checkpoint_path=path, resume=True)
    assert saved == [2, 3, 5, 6]
    assert resumed.iterations == 6
    assert resumed.cost == full.cost
    for f in dataclasses.fields(full.params):
        assert torch.equal(getattr(resumed.params, f.name),
                           getattr(full.params, f.name)), f.name


def test_tiles_cache_keeps_the_block_across_rounds(bal):
    """``solve_tiles_prepared`` keeps its block in ``_cache`` and refreshes
    its copies of the layout and freeze masks each call: a second round
    with other masks gives the Python driver's bits for that round."""
    _, scene, free = bal
    tiles, params_t, free_t = tt.tiles_from_scene(scene, free,
                                                  chunk_obs=256)
    frozen = flatten_camera(freeze_masks(scene, freeze_camera=True))
    full = flatten_camera(free)
    opts = SolverOptions(max_iterations=3, **TILE_OPTS)
    cache: dict = {}
    for cam_free in (frozen, full):
        wl = tt.solve_tiles_prepared(params_t, tiles, free_t, cam_free, opts,
                                     driver="while_loop", while_block=2,
                                     _cache=cache)
        py = tt.solve_tiles_prepared(params_t, tiles, free_t, cam_free, opts)
        _same(wl, py)
    assert "block" in cache
    with pytest.raises(ValueError, match="unknown driver"):
        tt.solve_tiles_prepared(params_t, tiles, free_t, full, opts,
                                driver="scan")

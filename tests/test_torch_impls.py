"""Port parity: the grid engine's torch path (``impl="planes"`` /
``"einsum"``, the monolithic kernels' plain versions), ``band="none"`` and
the pipeline's and CLI's ``impl`` routing, against the JAX package on its
CPU backend in float64.

Tolerances (the reference's own, tests/test_rig_grid.py:180-200): the
linearize pieces rtol 1e-7 / atol 1e-10, costs rtol 1e-12; LM steps and
solves as tests/test_torch_rig_grid.py holds the kernel path (cost rtol
1e-6, iterates rtol 1e-5 / atol 1e-8); the port against itself (drivers,
the default fused step) bit for bit."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deeparc_tpu.config import SolverOptions as JSolverOptions
from deeparc_tpu.io import make_hemisphere_rig
from deeparc_tpu.residuals.reprojection import flatten_camera as jflatten
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver import rig_grid as jrg
from deeparc_tpu_torch.config import PipelineOptions, SolverOptions
from deeparc_tpu_torch.pipeline import driver as tdriver
from deeparc_tpu_torch.residuals.reprojection import flatten_camera
from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
from deeparc_tpu_torch.solver import rig_grid as trg
from torch_parity import close, grid_to_torch, params_to_torch

OPTIONS = dict(linear_solver="dense_schur")
# an occlusion rig the band prep takes, and a small uniform one it declines
OCCLUSION = dict(n_arc=3, n_ring=16, n_points=300, occlusion_rings=4,
                 visibility=0.9, pixel_noise=0.8, point_noise=0.02, seed=7)
SMALL = dict(n_arc=3, n_ring=5, n_points=50, pixel_noise=0.5,
             point_noise=0.04, visibility=0.8, seed=31, focal_size=2,
             dist_size=2)


@pytest.fixture(scope="module")
def small():
    rig = make_hemisphere_rig(**SMALL)
    jscene = jfrom_deeparc(rig.data)
    jgrid, jfree = jrg.grid_from_scene(jscene), jfreeze(jscene)
    tfree = params_to_torch(jfree)
    return dict(jparams=jscene.params, jgrid=jgrid, jfree=jfree,
                params=params_to_torch(jscene.params),
                grid=grid_to_torch(jgrid), free=tfree, data=rig.data)


@pytest.mark.parametrize("impl", ["planes", "einsum"])
@pytest.mark.parametrize("loss", ["trivial", "huber"])
def test_assemble_and_cost_match_jax(small, impl, loss):
    """Chunks of 16 points (4 chunks, the last partial) on both sides."""
    jparams, jgrid, jfree = small["jparams"], small["jgrid"], small["jfree"]
    params, grid, free = small["params"], small["grid"], small["free"]
    want = jrg.assemble_grid_system(
        jparams.points, jrg.slot_params(jparams, jgrid), jgrid,
        jflatten(jfree), jfree.points, chunk_size=16, loss=loss,
        loss_scale=2.0, impl=impl)
    sp = trg.slot_params(params, grid)
    got = trg.assemble_grid_system(
        params.points, sp, grid, flatten_camera(free), free.points,
        chunk_size=16, loss=loss, loss_scale=2.0, impl=impl)
    close(got.cost, want.cost, 1e-12)
    for name in ("g_p", "hpp", "g_c", "hcc", "E"):
        close(getattr(got, name), getattr(want, name), 1e-7, 1e-10)
    close(trg.grid_cost(params.points, sp, grid, chunk_size=16, loss=loss,
                        loss_scale=2.0, impl=impl),
          jrg.grid_cost(jparams.points, jrg.slot_params(jparams, jgrid),
                        jgrid, chunk_size=16, loss=loss, loss_scale=2.0,
                        impl=impl), 1e-12)


@pytest.mark.parametrize("impl", ["planes", "einsum"])
@pytest.mark.parametrize("fuse_trial", [False, True])
def test_grid_steps_match_jax(small, impl, fuse_trial):
    """Three LM steps of each torch path, classic and fused: the same
    accept decisions and iterates as the reference's."""
    jopts, opts = JSolverOptions(**OPTIONS), SolverOptions(**OPTIONS)
    jcf, jpf = jflatten(small["jfree"]), small["jfree"].points
    cf, pf = flatten_camera(small["free"]), small["free"].points
    jstep = jax.jit(jrg.make_grid_step(jopts, small["jparams"], 32,
                                       impl=impl, fuse_trial=fuse_trial))
    step = trg.make_grid_step(opts, small["params"], 32, impl=impl,
                              fuse_trial=fuse_trial)
    if fuse_trial:
        js = jrg.init_grid_state_fused(small["jparams"], small["jgrid"],
                                       jopts, jcf, jpf, impl=impl,
                                       chunk_size=32)
        s = trg.init_grid_state_fused(small["params"], small["grid"], opts,
                                      cf, pf, 32, impl)
    else:
        js = jrg.init_grid_state(small["jparams"], small["jgrid"], jopts,
                                 impl=impl)
        s = trg.init_grid_state(small["params"], small["grid"], opts, impl)
    close(s.cost, js.cost, 1e-12)
    for _ in range(3):
        js, jinfo = jstep(js, small["jgrid"], jcf, jpf)
        s, info = step(s, small["grid"], cf, pf)
        assert bool(info.accepted) == bool(jinfo.accepted)
        close(s.cost, js.cost, 1e-6)
    close(s.points, js.points, 1e-5, 1e-8)
    close(s.cam_vec, js.cam_vec, 1e-5, 1e-8)


def test_unknown_impl_raises(small):
    with pytest.raises(ValueError, match="unknown grid impl"):
        trg.make_grid_step(SolverOptions(), small["params"], impl="xla")
    with pytest.raises(ValueError, match="unknown band"):
        trg.solve_ba_grid(small["params"], small["grid"], small["free"],
                          band="off")


@pytest.fixture(scope="module")
def occlusion():
    data = make_hemisphere_rig(**OCCLUSION).data
    jscene = jfrom_deeparc(data)
    scene = from_deeparc(data, device="cpu")
    return (jscene, jrg.grid_from_scene(jscene), scene,
            trg.grid_from_scene(scene))


def _solve(scene, grid, **kw):
    opts = SolverOptions(max_iterations=3, **OPTIONS)
    return trg.solve_ba_grid(scene.params, grid, freeze_masks(scene), opts,
                             chunk_size=128, **kw)


def test_solve_planes_takes_the_fused_step_and_matches_jax(occlusion,
                                                          monkeypatch):
    """``fuse_trial=None`` is the fused step off the kernels, as in the
    reference (whose ``impl="planes"`` default fuses too), and the classic
    step on them."""
    jscene, jgrid, scene, grid = occlusion
    want = jrg.solve_ba_grid(jscene.params, jgrid, jfreeze(jscene),
                             JSolverOptions(max_iterations=3, **OPTIONS),
                             impl="planes", chunk_size=128)
    fused = []
    make = trg.make_grid_step
    monkeypatch.setattr(trg, "make_grid_step", lambda *a, **kw: (
        fused.append(kw["fuse_trial"]), make(*a, **kw))[1])
    got = _solve(scene, grid, impl="planes")
    _solve(scene, grid, band="none")
    assert fused == [True, False]
    assert got.iterations == want.iterations == 3
    close(got.cost, want.cost, 1e-6)
    close(got.params.points, want.params.points, 1e-5, 1e-8)
    close(flatten_camera(got.params), jflatten(want.params), 1e-5, 1e-8)


def test_band_none_matches_the_banded_solve(occlusion):
    """``band="none"`` runs the monolithic kernels (no band prep, so the
    caller's band_reuse stays empty) and lands where the banded solve
    does."""
    _, _, scene, grid = occlusion
    state: dict = {}
    mono = _solve(scene, grid, band="none", band_reuse=state)
    assert state == {}
    banded = _solve(scene, grid, band_reuse=state)
    assert state["prep"] is not None
    assert mono.iterations == banded.iterations
    close(mono.cost, banded.cost, 1e-9)
    close(mono.params.points, banded.params.points, 1e-7, 1e-10)


@pytest.mark.parametrize("impl", ["planes", "einsum"])
def test_while_loop_gives_the_python_drivers_bits(occlusion, impl):
    _, _, scene, grid = occlusion
    py = _solve(scene, grid, impl=impl)
    wl = _solve(scene, grid, impl=impl, driver="while_loop", while_block=2)
    assert (wl.iterations, wl.status) == (py.iterations, py.status)
    assert wl.cost == py.cost
    for f in dataclasses.fields(py.params):
        assert torch.equal(getattr(wl.params, f.name),
                           getattr(py.params, f.name)), f.name


def test_pipeline_routes_impl_as_jax_does():
    """The reference's routing (pipeline/driver.py:183-188, 274-278): the
    grid engine reads "xla" as "planes", the tile engine "planes" /
    "einsum" as "xla"; "auto" stays the kernels."""
    for impl, grid, tile in (("auto", "auto", "auto"),
                             ("pallas", "pallas", "pallas"),
                             ("planes", "planes", "xla"),
                             ("einsum", "einsum", "xla"),
                             ("xla", "planes", "xla"),
                             ("dual", "dual", "dual")):
        assert tdriver.grid_impl(impl) == grid
        assert tdriver.tile_impl(impl) == tile


@pytest.mark.parametrize("impl", ["planes", "xla"])
def test_pipeline_with_a_torch_impl_matches_jax(impl, small, capsys):
    """run_pipeline with ``impl`` on a grid scene: the solves take the
    grid's torch path ("xla" -> "planes") and land where the reference's
    pipeline with the same impl does."""
    from deeparc_tpu.config import PipelineOptions as JPipelineOptions
    from deeparc_tpu.pipeline.driver import run_pipeline as jrun_pipeline
    from deeparc_tpu_torch.pipeline import run_pipeline

    solver = dict(max_iterations=10, **OPTIONS)
    want = jrun_pipeline(small["data"], JPipelineOptions(
        solver=JSolverOptions(**solver), write_snapshots=False, impl=impl),
        verbose=False)
    got = run_pipeline(small["data"], PipelineOptions(
        solver=SolverOptions(**solver), write_snapshots=False, impl=impl),
        device="cpu", verbose=True)
    assert "impl=planes, torch ops" in capsys.readouterr().out
    assert got.filter_rounds == want.filter_rounds
    assert got.scene.n_points == want.scene.n_points
    np.testing.assert_allclose(got.final_cost, want.final_cost, rtol=1e-6)


def test_cli_impl_flag(tmp_path, capsys):
    """``--impl planes`` on a synthetic rig: the grid's torch path, the
    outputs written."""
    from deeparc_tpu_torch.pipeline.cli import main

    rc = main(["--synthetic", "--n-arc", "3", "--n-ring", "5",
               "--n-points", "60", "--max-iterations", "3", "--device",
               "cpu", "--impl", "planes", "--no-snapshots", "-o",
               str(tmp_path)])
    assert rc == 0
    assert "impl=planes, torch ops" in capsys.readouterr().out
    assert any(p.name.endswith("_output.deeparc") for p in tmp_path.iterdir())
    with pytest.raises(SystemExit):
        main(["--synthetic", "--device", "cpu", "--impl", "dual"])

"""Port parity: the indexed (observation-list) engine -- the Jacobian
blocks, the Schur system and its solves, ``solve_ba`` and
``run_pipeline(engine="indexed")`` (PyTorch port on the CPU vs the JAX
package in float64) -- and the fixed-order maps the card sums through.

Tolerances: the Jacobian blocks 1e-12 relative (the same forward-mode AD
of the same residual); the system's sums (g_p, H_pp, g_c, diag H_cc),
``dense_S`` and ``reduced_rhs`` 1e-10 (sums in another order); one
``solve_schur`` step 1e-9 for ``dense_schur`` (a Cholesky solve) and 1e-6
for ``iterative_schur`` (a PCG stopped by its tolerance); ``solve_ba`` the
same iteration count and the final cost within 1e-8; the pipeline the same
rounds and surviving points and the final RMSE within 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.config import PipelineOptions as JPipelineOptions
from deeparc_tpu.config import SolverOptions as JSolverOptions
from deeparc_tpu.io import make_hemisphere_rig
from deeparc_tpu.pipeline.driver import run_pipeline as jrun_pipeline
from deeparc_tpu.residuals import reprojection as jrep
from deeparc_tpu.scene import freeze_masks as jfreeze
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver import schur as jschur
from deeparc_tpu.solver.ba import solve_ba as jsolve_ba
from deeparc_tpu_torch.config import PipelineOptions, SolverOptions
from deeparc_tpu_torch.kernels.tile import sum_rows_plain
from deeparc_tpu_torch.pipeline import run_pipeline
from deeparc_tpu_torch.residuals import reprojection as trep
from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
from deeparc_tpu_torch.solver import schur as tschur
from deeparc_tpu_torch.solver.ba import solve_ba
from torch_parity import as_np, close


@pytest.fixture(scope="module")
def scenes():
    """The rig of tests/test_pose_graph.py's incremental test, with its
    intrinsics free (all three camera column groups live) and a few
    observations masked."""
    rig = make_hemisphere_rig(n_arc=3, n_ring=5, n_points=56, pixel_noise=0.5,
                              point_noise=0.04, seed=6)
    js = jfrom_deeparc(rig.data)
    ts = from_deeparc(rig.data, device="cpu")
    keep = (np.arange(js.n_obs) % 17 != 3).astype(np.float64)
    js = dataclasses.replace(js, index=dataclasses.replace(
        js.index, obs_mask=jnp.asarray(keep)))
    ts = dataclasses.replace(ts, index=dataclasses.replace(
        ts.index, obs_mask=torch.tensor(keep)))
    jfree = jfreeze(js, optimize_intrinsics=True)
    tfree = freeze_masks(ts, optimize_intrinsics=True)
    return rig.data, js, ts, jfree, tfree


def test_jacobian_blocks_flat_match_jax(scenes):
    _, js, ts, _, _ = scenes
    want = jrep.jacobian_blocks_flat(js.params, js.index)
    got = trep.jacobian_blocks_flat(ts.params, ts.index, chunk=97)
    for name in ("r", "jp", "jc"):
        close(getattr(got, name), np.asarray(getattr(want, name)), 1e-12,
              1e-12 * float(np.abs(np.asarray(getattr(want, name))).max()))
    blocks = trep.jacobian_blocks(ts.params, ts.index)
    M = ts.n_obs
    assert blocks.j_point.shape == (M, 2, 3)
    assert blocks.j_cam.shape == (M, 2, trep.OBS_CAM_DIM)
    assert trep.camera_dim(ts.params) == jrep.camera_dim(js.params)
    np.testing.assert_array_equal(
        as_np(trep.camera_col_indices(ts.index, ts.params.ext_rot.shape[0])),
        np.asarray(jrep.camera_col_indices(js.index,
                                           js.params.ext_rot.shape[0])))


@pytest.fixture(scope="module")
def systems(scenes):
    """Both packages' systems built from the reference's Jacobian blocks."""
    _, js, ts, jfree, tfree = scenes
    b = jrep.jacobian_blocks_flat(js.params, js.index)
    N, R, K = (js.n_points, js.params.ext_rot.shape[0],
               js.params.center.shape[0])
    jcf, tcf = jrep.flatten_camera(jfree), trep.flatten_camera(tfree)
    jsys = jschur.build_system(b.r, b.jp, b.jc, js.index, N, R, K, jcf,
                               jfree.points)
    t = lambda a: torch.tensor(np.asarray(a))
    maps = tschur.schur_maps(ts.index, N, R, K)
    tsys = tschur.build_system(t(b.r), t(b.jp), t(b.jc), ts.index, N, R, K,
                               tcf, tfree.points, maps)
    return jsys, tsys


def test_build_system_dense_S_reduced_rhs_match_jax(systems):
    jsys, tsys = systems
    for name in ("g_p", "hpp", "g_c", "hcc_diag"):
        close(getattr(tsys, name), np.asarray(getattr(jsys, name)), 1e-10,
              1e-10 * float(np.abs(np.asarray(getattr(jsys, name))).max()))
    opts = SolverOptions()
    radius = torch.tensor(1e4, dtype=torch.float64)
    binv = tschur.augmented_point_blocks(tsys.hpp, tsys.point_free, radius,
                                         opts)
    jbinv = jschur._augmented_point_blocks(jsys, jnp.asarray(1e4),
                                           JSolverOptions())
    for got, want in ((tschur.dense_S(tsys, binv),
                       jschur.dense_S(jsys, jbinv)),
                      (tschur.reduced_rhs(tsys, binv),
                       jschur.reduced_rhs(jsys, jbinv))):
        want = np.asarray(want)
        close(got, want, 1e-10, 1e-10 * float(np.abs(want).max()))


@pytest.mark.parametrize("solver,tol", [("dense_schur", 1e-9),
                                        ("iterative_schur", 1e-6)])
def test_solve_schur_step_matches_jax(systems, solver, tol):
    jsys, tsys = systems
    dp, dc = tschur.solve_schur(tsys, torch.tensor(1e3, dtype=torch.float64),
                                SolverOptions(linear_solver=solver))
    jdp, jdc = jschur.solve_schur(jsys, jnp.asarray(1e3),
                                  JSolverOptions(linear_solver=solver))
    for got, want in ((dp, jdp), (dc, jdc)):
        want = np.asarray(want)
        close(got, want, tol, tol * float(np.abs(want).max()))


@pytest.mark.parametrize("solver,loss", [("dense_schur", "trivial"),
                                         ("iterative_schur", "trivial"),
                                         ("dense_schur", "cauchy")])
def test_solve_ba_matches_jax(scenes, solver, loss):
    data = scenes[0]
    js, ts = jfrom_deeparc(data), from_deeparc(data, device="cpu")
    kw = dict(max_iterations=10, linear_solver=solver, loss=loss)
    want = jsolve_ba(js.params, js.index, jfreeze(js), JSolverOptions(**kw))
    got = solve_ba(ts.params, ts.index, freeze_masks(ts), SolverOptions(**kw))
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.cost, float(want.cost), rtol=1e-8)
    close(got.params.points, np.asarray(want.params.points), 1e-6, 1e-9)


@pytest.mark.parametrize("solver", ["dense_schur", "iterative_schur"])
def test_solve_ba_while_loop_driver_matches_python_and_jax(scenes, solver):
    """``driver="while_loop"`` (the whole solve as one device loop; on the
    CPU its plain form) gives the Python driver's bits and the reference's
    ``driver="while_loop"`` iterations and cost (rtol 1e-8)."""
    data = scenes[0]
    js, ts = jfrom_deeparc(data), from_deeparc(data, device="cpu")
    kw = dict(max_iterations=6, linear_solver=solver, cg_tolerance=1e-6)
    want = jsolve_ba(js.params, js.index, jfreeze(js), JSolverOptions(**kw),
                     driver="while_loop")
    opts = SolverOptions(**kw)
    got = solve_ba(ts.params, ts.index, freeze_masks(ts), opts,
                   driver="while_loop")
    py = solve_ba(ts.params, ts.index, freeze_masks(ts), opts)
    assert (got.iterations, got.status) == (py.iterations, py.status)
    assert got.cost == py.cost
    for f in dataclasses.fields(got.params):
        assert torch.equal(getattr(got.params, f.name),
                           getattr(py.params, f.name)), f.name
    assert got.iterations == want.iterations
    np.testing.assert_allclose(got.cost, float(want.cost), rtol=1e-8)
    close(got.params.points, np.asarray(want.params.points), 1e-6, 1e-9)


def _sum_by_map(part, gmap, n_out):
    """What the card's gather kernel computes through a map: each output
    row the sum of its listed sources (a segmented map in two passes)."""
    flat = part.reshape(part.shape[0], -1)
    if len(gmap) == 4:
        flat = _sum_by_map(flat, gmap[:2], gmap[3].numel())
        gmap = gmap[2:]
    cstart, src = gmap[0].long(), gmap[1].long()
    rows = torch.repeat_interleave(torch.arange(n_out), cstart.diff())
    out = torch.zeros((n_out, flat.shape[1]), dtype=flat.dtype)
    return out.index_add_(0, rows, flat[src]).reshape(
        (n_out,) + part.shape[1:])


def test_schur_maps_cover_every_sum(scenes, monkeypatch):
    """Each fixed-order map of a solve lists exactly the sources of its
    sum: summing through the map equals ``index_add_`` over the key (camera
    rows cut into segments of 64 here, so the two-pass maps are held
    too)."""
    _, _, ts, _, _ = scenes
    monkeypatch.setattr(tschur, "CAM_SEGMENT", 64)
    idx = ts.index
    N, R, K = (ts.n_points, ts.params.ext_rot.shape[0],
               ts.params.center.shape[0])
    maps = tschur.schur_maps(idx, N, R, K)
    gen = torch.Generator().manual_seed(0)
    op, ids = idx.obs_point.long(), (idx.obs_outer.long(),
                                     idx.obs_inner.long(),
                                     idx.obs_intr.long())
    sizes = (R, R, K)
    cases = [(maps.point, op, N, 12)]
    cases += [(m, i, n, 6) for m, i, n in zip(maps[1:4], ids, sizes)]
    cases += [(m, op * n + i, N * n, 18)
              for m, i, n in zip(maps.dense_e, ids, sizes)]
    cases += [(m, i1 * n2 + i2, n1 * n2, 36)
              for m, (i1, n1, i2, n2) in zip(
                  maps.hcc, [(a, na, b, nb) for a, na in zip(ids, sizes)
                             for b, nb in zip(ids, sizes)])]
    assert len(cases) == 16
    for gmap, dst, n_out, F in cases:
        part = torch.randn((ts.n_obs, F), dtype=torch.float64, generator=gen)
        want = sum_rows_plain(part, dst, n_out)
        close(_sum_by_map(part, gmap, n_out), as_np(want), 1e-12, 1e-12)
    assert len(maps.outer) == 4          # camera rows are segmented


def test_indexed_pipeline_matches_jax(scenes):
    data = scenes[0]
    kw = dict(write_snapshots=False, engine="indexed")
    want = jrun_pipeline(data, JPipelineOptions(
        solver=JSolverOptions(max_iterations=10), **kw), verbose=False)
    got = run_pipeline(data, PipelineOptions(
        solver=SolverOptions(max_iterations=10), **kw), device="cpu",
        verbose=False)
    assert got.filter_rounds == want.filter_rounds
    assert got.scene.n_points == want.scene.n_points
    np.testing.assert_allclose(got.final_rmse_px, want.final_rmse_px,
                               rtol=1e-6)
    np.testing.assert_allclose(got.final_cost, want.final_cost, rtol=1e-6)


def test_cli_runs_the_indexed_engine(tmp_path, capsys):
    from deeparc_tpu_torch.pipeline.cli import main

    assert main(["--synthetic", "--n-arc", "3", "--n-ring", "4",
                 "--n-points", "40", "--device", "cpu", "--engine",
                 "indexed", "--max-iterations", "5", "--no-snapshots",
                 "-o", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "engine=indexed" in out and "[deeparc] done" in out
    assert (tmp_path / "synthetic_output.deeparc").exists()

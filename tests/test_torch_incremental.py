"""Port parity: the pose graph and BFS incremental BA (PyTorch port on the
CPU vs the JAX package in float64): ``relative_pose`` and the pose-graph
residuals, ``solve_pose_graph``, the BFS orders, ``run_incremental`` on a
shared rig (grid engine) and on a non-shared scene (tile engine, with and
without the pose graph), the full-mask band prep reused across batches,
and the CLI's ``--incremental`` on a shared rig and on a non-shared scene.

Tolerances: the pose-graph residuals at the truth 1e-12 (the same
formulas), refined poses 1e-8 (two LM runs to the same minimum); the BFS
orders equal; every batch's cost 1e-6 relative with equal iteration
counts (the same solves on the same data, sums in another order); the
reused band prep against a fresh prep per batch 1e-9 relative, equal
iteration counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeparc_tpu.config import PipelineOptions as JPipelineOptions
from deeparc_tpu.config import SolverOptions as JSolverOptions
from deeparc_tpu.io import make_hemisphere_rig
from deeparc_tpu.io.synthetic import make_bal_synthetic
from deeparc_tpu.pipeline import incremental as jinc
from deeparc_tpu.residuals import pose_graph as jpg
from deeparc_tpu.scene import from_deeparc as jfrom_deeparc
from deeparc_tpu.solver.rig_grid import grid_from_scene as jgrid_from
from deeparc_tpu_torch.config import PipelineOptions, SolverOptions
from deeparc_tpu_torch.pipeline import incremental as tinc
from deeparc_tpu_torch.residuals import pose_graph as tpg
from deeparc_tpu_torch.scene import from_deeparc
from deeparc_tpu_torch.solver.rig_grid import grid_from_scene
from torch_parity import as_np, close


def _poses(seed, n):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(scale=0.5, size=(n, 3)),
                           rng.normal(scale=1.0, size=(n, 3))], axis=1), rng


def _graphs(poses, edges):
    """Both packages' graphs, measured at the true poses."""
    i, j = edges[:, 0], edges[:, 1]
    jm = jpg.relative_pose(jnp.asarray(poses[i, :3]), jnp.asarray(poses[i, 3:]),
                           jnp.asarray(poses[j, :3]), jnp.asarray(poses[j, 3:]))
    t = torch.tensor(poses)
    tm = tpg.relative_pose(t[i, :3], t[i, 3:], t[j, :3], t[j, 3:])
    for got, want in zip(tm, jm):
        close(got, np.asarray(want), 1e-12, 1e-12)
    return (jpg.PoseGraph(jnp.asarray(edges, jnp.int32), *jm),
            tpg.PoseGraph(torch.tensor(edges, dtype=torch.int32), *tm))


def test_pose_graph_residuals_zero_at_truth():
    poses, _ = _poses(0, 6)
    edges = np.array([[i, (i + 1) % 6] for i in range(6)] + [[0, 3]])
    _, tg = _graphs(poses, edges)
    r = tpg.pose_graph_residuals(torch.tensor(poses.reshape(-1)), tg)
    np.testing.assert_allclose(as_np(r), 0.0, atol=1e-12)


def test_solve_pose_graph_matches_jax():
    """Chain plus loop closures (tests/test_pose_graph.py's odometry
    graph): the port refines the perturbed poses to the reference's, and
    the anchored pose does not move."""
    n = 8
    poses, rng = _poses(1, n)
    edges = np.array([[i, i + 1] for i in range(n - 1)]
                     + [[0, n - 1], [0, n // 2], [2, n - 2]])
    jg, tg = _graphs(poses, edges)
    noisy = poses.copy()
    noisy[1:] += rng.normal(scale=0.05, size=(n - 1, 6))
    anchor = np.zeros(n, dtype=bool)
    anchor[0] = True
    want = np.asarray(jpg.solve_pose_graph(jnp.asarray(noisy), jg,
                                           jnp.asarray(anchor)))
    got = tpg.solve_pose_graph(torch.tensor(noisy), tg, torch.tensor(anchor))
    close(got, want, 1e-8, 1e-8)
    np.testing.assert_array_equal(as_np(got[0]), noisy[0])
    r = tpg.pose_graph_residuals(got.reshape(-1), tg)
    assert float(r.abs().max()) < 1e-8


def test_bfs_orders_match_jax():
    rig = make_hemisphere_rig(n_arc=3, n_ring=6, n_points=60, seed=5)
    mask = np.asarray(jgrid_from(jfrom_deeparc(rig.data)).mask)
    for start in (0, 7):
        np.testing.assert_array_equal(
            tinc.bfs_cell_order(torch.tensor(mask), mask.shape[1], start),
            jinc.bfs_cell_order(mask, mask.shape[1], start))
    bal = make_bal_synthetic(n_cameras=12, n_points=90, seed=3)
    covis = jinc.camera_covisibility(jfrom_deeparc(bal.data))
    np.testing.assert_array_equal(
        tinc.camera_covisibility(from_deeparc(bal.data, device="cpu")), covis)
    np.testing.assert_array_equal(tinc.bfs_cell_order_from_covis(covis),
                                  jinc.bfs_cell_order_from_covis(covis))
    # an unreachable camera is appended in index order
    covis[:, 5] = covis[5, :] = 0
    order = tinc.bfs_cell_order_from_covis(covis, start=2)
    np.testing.assert_array_equal(order,
                                  jinc.bfs_cell_order_from_covis(covis, 2))
    assert order[-1] == 5


def _compare(want, got):
    assert got.batches == want.batches
    np.testing.assert_array_equal(got.order, want.order)
    assert ([h["iterations"] for h in got.history]
            == [h["iterations"] for h in want.history])
    assert ([h["active_cells"] for h in got.history]
            == [h["active_cells"] for h in want.history])
    np.testing.assert_allclose([h["cost"] for h in got.history],
                               [h["cost"] for h in want.history], rtol=1e-6)
    np.testing.assert_allclose(got.final_rmse_px, want.final_rmse_px,
                               rtol=1e-6)


def test_run_incremental_grid_matches_jax():
    """tests/test_pose_graph.py's incremental rig: one ring of 5 cells a
    batch on the grid engine, under the JAX package's rule that one active
    observation makes a point live (``min_observations=1``; the port's
    default of two is held to the benchmark's plain reference in
    tests/test_torch_incremental_reference.py)."""
    rig = make_hemisphere_rig(n_arc=3, n_ring=5, n_points=56, pixel_noise=0.5,
                              point_noise=0.04, seed=6)
    want = jinc.run_incremental(rig.data, JPipelineOptions(
        solver=JSolverOptions(max_iterations=6)), verbose=False)
    got = tinc.run_incremental(rig.data, PipelineOptions(
        solver=SolverOptions(max_iterations=6)), device="cpu", verbose=False,
        min_observations=1)
    _compare(want, got)
    assert got.batches == 3 and got.final_rmse_px < 1.0


@pytest.mark.parametrize("pose_graph", [True, False])
def test_run_incremental_free_matches_jax(pose_graph):
    """tests/test_pose_graph.py's free-camera scene on the tile engine, 4
    cameras a batch, with and without the pose-graph stage."""
    rig = make_bal_synthetic(n_cameras=8, n_points=80, track_length=5.0,
                             pixel_noise=0.3, point_noise=0.02,
                             ext_noise=0.01, seed=7)
    kw = dict(max_iterations=5, linear_solver="iterative_schur",
              cg_max_iterations=50)
    want = jinc.run_incremental(rig.data, JPipelineOptions(
        solver=JSolverOptions(**kw)), batch_size=4, verbose=False,
        pose_graph=pose_graph)
    got = tinc.run_incremental(rig.data, PipelineOptions(
        solver=SolverOptions(**kw)), batch_size=4, device="cpu",
        verbose=False, pose_graph=pose_graph)
    _compare(want, got)
    assert got.final_rmse_px < 2.0


def test_band_prep_reused_across_batches_matches_fresh_prep(monkeypatch):
    """One band prep of the full mask serves every batch (each batch's live
    set is a subset of it): the same results as a fresh prep per solve."""
    rig = make_hemisphere_rig(n_arc=3, n_ring=16, n_points=420,
                              occlusion_rings=4, visibility=0.9,
                              pixel_noise=0.8, point_noise=0.02, seed=5)
    opts = PipelineOptions(solver=SolverOptions(max_iterations=6))
    run = lambda: tinc.run_incremental(rig.data, opts, batch_size=16,
                                       device="cpu", verbose=False)
    grid = grid_from_scene(from_deeparc(rig.data, device="cpu"))
    assert tinc._band_state(grid)["prep"] is not None
    reused = run()
    monkeypatch.setattr(tinc, "_band_state", lambda grid: None)
    fresh = run()
    assert reused.batches == fresh.batches == 3
    assert ([h["iterations"] for h in reused.history]
            == [h["iterations"] for h in fresh.history])
    np.testing.assert_allclose([h["cost"] for h in reused.history],
                               [h["cost"] for h in fresh.history],
                               rtol=1e-9)
    close(reused.scene.params.points, as_np(fresh.scene.params.points),
          1e-7, 1e-9)


def test_cli_incremental(tmp_path, capsys):
    from deeparc_tpu.io import read_deeparc
    from deeparc_tpu_torch.pipeline.cli import main

    assert main(["--synthetic", "--n-arc", "3", "--n-ring", "5",
                 "--n-points", "56", "--device", "cpu", "--incremental",
                 "--batch-size", "5", "--max-iterations", "4",
                 "--no-pose-graph", "--quiet", "-o", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "incremental done: batches=3" in out
    back = read_deeparc(str(tmp_path / "synthetic_incremental.deeparc"))
    assert back.n_points == 56

    # a non-shared scene: the tile engine with the pose graph
    from deeparc_tpu.io import write_deeparc

    bal = make_bal_synthetic(n_cameras=8, n_points=80, track_length=5.0,
                             pixel_noise=0.3, point_noise=0.02,
                             ext_noise=0.01, seed=7)
    path = str(tmp_path / "bal.deeparc")
    write_deeparc(bal.data, path)
    assert main([path, "--device", "cpu", "--incremental", "--batch-size",
                 "4", "--max-iterations", "4",
                 "--linear-solver", "iterative_schur", "--quiet", "-o",
                 str(tmp_path)]) == 0
    assert "incremental done: batches=2" in capsys.readouterr().out
    back = read_deeparc(str(tmp_path / "bal_incremental.deeparc"))
    assert back.n_points == bal.data.n_points
    assert not back.share_extrinsic

"""BFS incremental BA of a shared rig (``run_incremental``) against the
benchmark's plain reference (``portbench/incremental.py``: plain PyTorch,
written from the method's description, nothing of the port or of JAX),
on the CPU at the benchmark cell's geometry cut to a 2 x 6 rig of a few
hundred points, 6 cells a batch.

Tolerances, each with its reason:
  * the BFS order, the active cells, the live points and both solves'
    iteration counts of every batch are equal: integers of the same
    method on the same data;
  * every batch's cost within 1e-12 relative: the same LM steps in
    float64, summed in another order (read 1.2e-14 at most on four
    seeds, under both rules of what makes a point live);
  * the final points, cameras and cost by the cell's own comparison
    (``judge.solve_gaps``) under the cell's limits (read: points 8.1e-12,
    cameras 3.5e-10, cost 6.9e-15 at most).
A port run that skips the structure solve, or that registers the cells
in reverse order, is judged not correct by the same limits."""

import numpy as np
import pytest
import torch

from deeparc_tpu_torch.config import PipelineOptions, SolverOptions
from deeparc_tpu_torch.pipeline import incremental as tinc
from portbench import answers, generate, judge
from portbench import incremental as inc
from portbench import reference as ref
from portbench.run import judge_answers, load_cell, load_module

CELL = "rig-occl.incremental"
# the cell cut to 2 arcs x 6 ring steps, 300 drawn points, a window of 3
# ring steps, one ring of cells a batch
SMALL = {"config": {"n_arc": 2, "n_ring": 6, "n_points": 300,
                    "incremental": {"batch_size": 6, "order": "bfs",
                                    "start_cell": 0,
                                    "min_observations": 2}},
         "traffic": {"occlusion_rings": 3, "visibility": 0.5}}
SEEDS = (1, 2 ** 31 + 5)


def _scene(seed):
    _, _, cell, cfg, traffic = load_cell(CELL, SMALL)
    return cell, cfg, generate.make(cfg, traffic, seed, torch.device("cpu"))


@pytest.mark.parametrize("min_observations", [2, 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_run_incremental_matches_the_plain_reference(seed, min_observations):
    """The default (two active observations make a point live) and the
    JAX package's rule (one)."""
    cell, cfg, data = _scene(seed)
    got = tinc.run_incremental(
        data, PipelineOptions(solver=SolverOptions(**cfg["solver"])),
        batch_size=6, device="cpu", verbose=False,
        min_observations=min_observations)
    want = inc.run(data, ref.Options.of(cfg["solver"]), 6, torch.float64,
                   "cpu", min_observations=min_observations)
    assert got.batches == len(want["history"]) == 2
    np.testing.assert_array_equal(got.order, want["order"])
    for key in ("active_cells", "live_points", "structure_iterations",
                "iterations"):
        assert [h[key] for h in got.history] == \
            [h[key] for h in want["history"]], key
    np.testing.assert_allclose([h["cost"] for h in got.history],
                               [h["cost"] for h in want["history"]],
                               rtol=1e-12)
    params = got.scene.params
    gaps = judge.solve_gaps(
        {"points": answers.host(params.points),
         "cameras": answers.cameras_of(params), "cost": got.final_cost},
        {"points": answers.host(want["points"]),
         "cameras": answers.host(ref.camera_vector(want["ext"],
                                                   want["intr"])),
         "cost": want["cost"]}, answers.start_of(data))
    for k, v in gaps.items():
        assert v <= cell["limits"][k], (k, v)
    assert got.solve_iterations == sum(
        h["structure_iterations"] + h["iterations"] for h in got.history)
    assert got.solve_seconds > 0 and got.cg_iterations == 0


@pytest.mark.parametrize("seed", SEEDS + (7,))
def test_bfs_order_equals_the_reference(seed):
    from deeparc_tpu_torch.scene import from_deeparc
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene

    _, _, data = _scene(seed)
    grid = grid_from_scene(from_deeparc(data, device="cpu"))
    counts = inc.covisibility(data)
    np.testing.assert_array_equal(tinc._covisibility(grid.mask > 0.5),
                                  counts)
    for start in (0, 5):
        np.testing.assert_array_equal(
            tinc.bfs_cell_order(grid.mask, grid.mask.shape[1], start),
            inc.bfs_order(counts, start))


def test_bfs_order_ties_and_unreached_cells():
    """Equal counts go by the lower index; cells no path reaches follow
    in index order."""
    counts = np.zeros((7, 7), np.int64)
    for i, j, n in ((0, 4, 2), (0, 2, 2), (0, 1, 5), (2, 3, 1), (4, 3, 9)):
        counts[i, j] = counts[j, i] = n
    want = inc.bfs_order(counts, 0)
    np.testing.assert_array_equal(want, [0, 1, 2, 4, 3, 5, 6])
    np.testing.assert_array_equal(tinc.bfs_cell_order_from_covis(counts, 0),
                                  want)
    np.testing.assert_array_equal(tinc.bfs_cell_order_from_covis(counts, 3),
                                  inc.bfs_order(counts, 3))


def _skip_structure(monkeypatch):
    """Every camera-frozen solve returns its start: the structure solve
    skipped."""
    from deeparc_tpu_torch.solver import rig_grid

    real = rig_grid.solve_ba_grid

    def broken(params, grid, free, *args, **kwargs):
        if not bool(torch.any(free.ext_rot != 0)):
            return rig_grid.BAResult(params, 0.0, 0, 0)
        return real(params, grid, free, *args, **kwargs)

    monkeypatch.setattr(rig_grid, "solve_ba_grid", broken)


def _reverse_order(monkeypatch):
    real = tinc.bfs_cell_order
    monkeypatch.setattr(tinc, "bfs_cell_order",
                        lambda *a, **k: real(*a, **k)[::-1].copy())


def _judged(seed):
    """The cell's judgement of one call of its entry: (worst gaps, failed
    answers), as ``portbench.run`` reaches it (``run_cell`` itself
    refuses a process that has loaded JAX, as the tests' processes
    have)."""
    cell, cfg, data = _scene(seed)
    entry = load_module("entries", cell["entry"])
    dev = torch.device("cpu")
    ctx = {"config": cfg, "data": data, "device": dev,
           "start": answers.start_of(data)}
    calls = [entry.call(entry.setup(ctx))]
    return judge_answers(entry, calls, entry.reference(ctx, torch.float64),
                         ctx, cell["limits"])


def test_the_cells_entry_is_correct():
    gaps, failed = _judged(3)
    assert failed == 0, gaps


@pytest.mark.parametrize("fault", [_skip_structure, _reverse_order],
                         ids=["structure_skipped", "order_reversed"])
def test_faulty_incremental_run_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    gaps, failed = _judged(3)
    assert failed == 1
    assert gaps["points_gap"] > 1e-4 and gaps["cameras_gap"] > 1e-2

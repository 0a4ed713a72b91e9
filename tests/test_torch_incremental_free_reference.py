"""BFS incremental BA of independent cameras with the pose graph
(``run_incremental`` on a non-shared scene) against the benchmark's plain
reference (``portbench/incremental_free.py``: plain PyTorch, written from
the method's description, nothing of the port or of JAX), on the CPU at
the cell ``bal-venice.incremental``'s geometry cut to 24 cameras, 600
points and 1,800 observations from windows of 6 cameras, 3 cameras a
batch, on two scenes. Also the pose graph's normal-equations LM against
the dense LM, and one tile layout and one LM step a reconstruction.

Tolerances, each with its reason:
  * the BFS order, the pose-graph edges (i, j, batch captured), and per
    batch the registered cameras, live points, edges and both solves'
    iteration counts are equal: integers of the same method on the same
    data;
  * every batch's cost within 1e-12 relative: the same LM steps in
    float64, summed in another order (read 1.1e-15 at most);
  * the final answer by the cell's own comparison under the cell's
    limits (read: points 5.6e-13, cameras 8.0e-12, cost 8.4e-16 at most);
  * the pose-graph LM against the dense LM: the same iterations and
    status, poses within 1e-12 (read 1.9e-13: the same steps, J^T J
    summed in blocks instead of by a matrix product).
A run that skips the pose graph, registers the cameras in reverse order,
or captures each batch's edges one batch late is judged not correct by
the same limits."""

import functools

import numpy as np
import pytest
import torch

from deeparc_tpu_torch.config import PipelineOptions, SolverOptions
from deeparc_tpu_torch.pipeline import incremental as tinc
from deeparc_tpu_torch.residuals import pose_graph as tpg
from deeparc_tpu_torch.solver.lm import levenberg_marquardt
from portbench import answers, generate
from portbench.run import judge_answers, load_cell, load_module

CELL = "bal-venice.incremental"
BATCH = 3


def _cut(scene_seed):
    return {"config": {"n_cameras": 24, "n_points": 600,
                       "n_observations": 1800, "scene_seed": scene_seed,
                       "incremental": {"batch_size": BATCH, "order": "bfs",
                                       "start_camera": 0,
                                       "min_observations": 2,
                                       "pose_graph": True, "min_covis": 3,
                                       "pose_graph_iterations": 20}},
            "traffic": {"window": 6, "track_clip": 6}}


SCENES = (1, 2 ** 31 + 5)


@functools.lru_cache(maxsize=None)
def _scene(scene_seed):
    _, _, cell, cfg, traffic = load_cell(CELL, _cut(scene_seed))
    return cell, cfg, generate.make(cfg, traffic, 2 ** 32 + 3,
                                    torch.device("cpu"))


@functools.lru_cache(maxsize=None)
def _reference(scene_seed):
    _, cfg, data = _scene(scene_seed)
    entry = load_module("entries", "incremental_free")
    return entry.reference(_ctx(cfg, data), torch.float64)


def _ctx(cfg, data):
    return {"config": cfg, "data": data, "device": torch.device("cpu"),
            "start": answers.start_of(data)}


def _run(data, cfg):
    return tinc.run_incremental(
        data, PipelineOptions(solver=SolverOptions(**cfg["solver"])),
        batch_size=BATCH, device="cpu", verbose=False)


def _judged(scene_seed):
    """The cell's judgement of one call of its entry against the
    reference: (worst gaps, failed answers)."""
    cell, cfg, data = _scene(scene_seed)
    entry = load_module("entries", cell["entry"])
    ctx = _ctx(cfg, data)
    calls = [entry.call(entry.setup(ctx))]
    return judge_answers(entry, calls, _reference(scene_seed), ctx,
                         cell["limits"])


@pytest.mark.parametrize("scene_seed", SCENES)
def test_free_path_matches_the_plain_reference(scene_seed):
    cell, cfg, data = _scene(scene_seed)
    got = _run(data, cfg)
    want = _reference(scene_seed)
    assert got.batches == len(want["history"]) == 8
    np.testing.assert_array_equal(got.order, want["order"])
    np.testing.assert_array_equal(got.edges, want["edges"])
    # some covisible pairs share fewer than min_covis points
    assert 0 < got.edges.shape[0] < 24 * 23 // 2
    for g, w in zip(got.history, want["history"]):
        assert (g["active_cells"], g["live_points"], g["edges"],
                g["structure_iterations"], g["iterations"]) == (
            w["active_cameras"], w["live_points"], w["edges"],
            w["structure_iterations"], w["iterations"])
    np.testing.assert_allclose([h["cost"] for h in got.history],
                               [h["cost"] for h in want["history"]],
                               rtol=1e-12)
    entry = load_module("entries", cell["entry"])
    params = got.scene.params
    gaps = entry.gaps({"points": answers.host(params.points),
                       "cameras": answers.cameras_of(params),
                       "cost": got.final_cost, "order": got.order,
                       "edges": got.edges}, want, _ctx(cfg, data))
    for k, v in gaps.items():
        assert v <= cell["limits"][k], (k, v)


def test_one_layout_and_one_step_a_reconstruction(monkeypatch):
    """Every solve of a reconstruction runs on one ``tiles_from_scene``
    layout with one ``make_tile_step`` step."""
    from deeparc_tpu_torch.solver import tiles

    calls = {"layout": 0, "step": 0}

    def counted(name, real):
        def fn(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return fn

    monkeypatch.setattr(tiles, "tiles_from_scene",
                        counted("layout", tiles.tiles_from_scene))
    monkeypatch.setattr(tiles, "make_tile_step",
                        counted("step", tiles.make_tile_step))
    _, cfg, data = _scene(SCENES[0])
    res = _run(data, cfg)
    assert res.batches == 8 and len(res.history) == 8
    assert calls == {"layout": 1, "step": 1}


def _graph(seed, n, m):
    """A random graph of ``m`` distinct edges over ``n`` poses, measured
    at the true poses, and perturbed starting poses."""
    rng = np.random.default_rng(seed)
    poses = torch.tensor(np.concatenate(
        [rng.normal(scale=0.5, size=(n, 3)), rng.normal(size=(n, 3))], 1))
    pairs = set()
    while len(pairs) < m:
        pairs.add(tuple(sorted(int(v) for v in rng.choice(n, 2, False))))
    e = torch.tensor(sorted(pairs))
    i, j = e[:, 0], e[:, 1]
    mr, mt = tpg.relative_pose(poses[i, :3], poses[i, 3:], poses[j, :3],
                               poses[j, 3:])
    noisy = poses + torch.tensor(rng.normal(scale=0.05, size=(n, 6)))
    return tpg.PoseGraph(e, mr, mt), noisy


@pytest.mark.parametrize("anchored", [(0,), (0, 3, 7), ()],
                         ids=["gauge", "three", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pose_graph_lm_matches_the_dense_lm(seed, anchored):
    graph, x0 = _graph(seed, 12, 30)
    anchor = torch.zeros(12, dtype=torch.bool)
    anchor[list(anchored)] = True
    options = SolverOptions(max_iterations=20)
    free = torch.repeat_interleave(1.0 - anchor.double(), 6)
    dense = levenberg_marquardt(tpg.pose_graph_residuals, x0.reshape(-1),
                                options, free, graph)
    got = tpg.pose_graph_lm(x0, graph, anchor, options)
    assert (got.iterations, got.status) == (dense.iterations, dense.status)
    np.testing.assert_allclose(got.x.numpy(),
                               dense.x.reshape(-1, 6).numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(got.x[anchor].numpy(), x0[anchor].numpy())


def _skip_pose_graph(monkeypatch):
    from deeparc_tpu_torch.solver.lm import LMResult

    monkeypatch.setattr(tpg, "pose_graph_lm", lambda poses0, *a, **k:
                        LMResult(poses0, torch.zeros(()), 0, 0))


def _reverse_order(monkeypatch):
    real = tinc.bfs_cell_order_from_covis
    monkeypatch.setattr(tinc, "bfs_cell_order_from_covis",
                        lambda *a, **k: real(*a, **k)[::-1].copy())


def _late_edges(monkeypatch):
    """Each batch captures the pairs that the batch before it made."""
    real, held = tinc._new_pairs, []

    def late(*args):
        held.append(real(*args))
        return held[-2] if len(held) > 1 else held[0][:0]

    monkeypatch.setattr(tinc, "_new_pairs", late)


@pytest.mark.parametrize("fault", [_skip_pose_graph, _reverse_order,
                                   _late_edges],
                         ids=["pose_graph_skipped", "order_reversed",
                              "edges_late"])
def test_faulty_free_run_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    gaps, failed = _judged(SCENES[0])
    assert failed == 1, gaps

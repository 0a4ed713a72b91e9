"""The port's spans (``deeparc_tpu_torch/utils/profiling.py``) on the CPU:
their ids and self times, that they record nothing with no profiler
running, that they share the profiler's clock, and the span trees a grid
pipeline and a tile solve leave."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from deeparc_tpu_torch.config import PipelineOptions, SolverOptions
from deeparc_tpu_torch.io.synthetic import (
    make_bal_synthetic,
    make_hemisphere_rig,
)
from deeparc_tpu_torch.pipeline import run_pipeline
from deeparc_tpu_torch.residuals.reprojection import flatten_camera
from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
from deeparc_tpu_torch.solver import tiles as tt
from deeparc_tpu_torch.solver.rig_grid import grid_from_scene, solve_ba_grid
from deeparc_tpu_torch.utils import profiling
from deeparc_tpu_torch.utils.profiling import (
    NO_SPAN,
    reset_spans,
    span,
    span_report,
    spans,
)

# an occlusion rig the band prep takes (tests/test_torch_rig_grid.py)
BANDED_RIG = dict(n_arc=3, n_ring=16, n_points=300, occlusion_rings=4,
                  visibility=0.9, pixel_noise=0.8, point_noise=0.02, seed=7)


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler`` session, from no records;
    returns (its result, the profiler, the records)."""
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, spans()


def _by_name(records):
    out: dict = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def test_the_profilers_flag_exists():
    """Tracing reads torch's own flag; a torch that renames it must fail
    here, not leave tracing off."""
    import torch.autograd.profiler as ap

    assert ap._is_profiler_enabled is False
    assert span("deeparc.x") is NO_SPAN
    with profile(activities=[ProfilerActivity.CPU]):
        assert ap._is_profiler_enabled is True
        assert span("deeparc.x") is not NO_SPAN
    assert ap._is_profiler_enabled is False


def test_nesting_gives_parent_and_shared_root_ids():
    def run():
        with span("a"):
            with span("b"):
                with span("c", n=2) as sp:
                    sp.set(m=3)
            with span("d"):
                pass
        with span("e"):
            pass

    _, _, recs = _profiled(run)
    r = {x["name"]: x for x in recs}
    assert [x["name"] for x in recs] == ["a", "b", "c", "d", "e"]
    assert r["a"]["parent"] is None and r["a"]["root"] == r["a"]["id"]
    assert r["b"]["parent"] == r["a"]["id"]
    assert r["c"]["parent"] == r["b"]["id"]
    assert r["d"]["parent"] == r["a"]["id"]
    assert {r[k]["root"] for k in "abcd"} == {r["a"]["id"]}
    assert r["e"]["parent"] is None and r["e"]["root"] == r["e"]["id"]
    assert r["c"]["counts"] == {"n": 2, "m": 3}
    assert all(x["end_ns"] >= x["start_ns"] for x in recs)


def test_self_time_is_duration_less_the_childrens_cover():
    recs = [
        {"id": 1, "parent": None, "root": 1, "name": "p", "start_ns": 0,
         "end_ns": 100, "counts": {}, "device_s": None},
        {"id": 2, "parent": 1, "root": 1, "name": "c", "start_ns": 10,
         "end_ns": 30, "counts": {"k": 2}, "device_s": 0.5},
        {"id": 3, "parent": 1, "root": 1, "name": "c", "start_ns": 50,
         "end_ns": 90, "counts": {"k": 3}, "device_s": 0.25},
        {"id": 4, "parent": 3, "root": 1, "name": "g", "start_ns": 60,
         "end_ns": 70, "counts": {}, "device_s": None},
        # still open: left out
        {"id": 5, "parent": None, "root": 5, "name": "open",
         "start_ns": 95, "end_ns": None, "counts": {}, "device_s": None},
    ]
    rep = span_report(recs)
    assert set(rep) == {"p", "c", "g"}
    assert rep["p"]["total_s"] == pytest.approx(100e-9)
    assert rep["p"]["self_s"] == pytest.approx(40e-9)
    assert rep["c"]["count"] == 2
    assert rep["c"]["total_s"] == pytest.approx(60e-9)
    assert rep["c"]["self_s"] == pytest.approx(50e-9)
    assert rep["c"]["device_s"] == pytest.approx(0.75)
    assert rep["c"]["counts"] == {"k": 5}
    assert rep["g"]["self_s"] == pytest.approx(10e-9)
    assert rep["p"]["device_s"] is None

    # measured spans: a parent's self time is its duration less its child's
    def run():
        with span("outer"):
            sum(range(20000))
            with span("inner"):
                sum(range(20000))

    _, _, got = _profiled(run)
    o, i = got
    rep = span_report(got)
    want = (o["end_ns"] - o["start_ns"]) - (i["end_ns"] - i["start_ns"])
    assert rep["outer"]["self_s"] == pytest.approx(want * 1e-9)
    assert rep["inner"]["self_s"] == pytest.approx(rep["inner"]["total_s"])


def test_off_is_the_shared_no_op_and_a_grid_solve_records_nothing():
    reset_spans()
    assert span("deeparc.x") is NO_SPAN
    assert span("deeparc.y", device=True, n=1) is NO_SPAN
    with span("deeparc.x") as sp:
        sp.set(n=2)
    rig = make_hemisphere_rig(**BANDED_RIG)
    scene = from_deeparc(rig.data, device="cpu")
    res = solve_ba_grid(scene.params, grid_from_scene(scene),
                        freeze_masks(scene),
                        SolverOptions(max_iterations=2,
                                      progress_to_stdout=False))
    assert res.iterations >= 1
    assert spans() == []


def test_spans_share_the_profilers_clock():
    """Each span is a profiler range, and holds the torch op called
    inside it on the profiler's clock."""
    def run():
        with span("deeparc.test.outer"):
            x = torch.ones(64, dtype=torch.float64)
            with span("deeparc.test.inner"):
                x.sum()

    _, prof, recs = _profiled(run)
    events = prof.events()
    ranges = {e.name: e.time_range for e in events
              if e.name.startswith("deeparc.test.")}
    assert set(ranges) == {r["name"] for r in recs}
    ops = [e.time_range for e in events if e.name == "aten::sum"]
    assert ops
    outer, inner = ranges["deeparc.test.outer"], ranges["deeparc.test.inner"]
    assert any(inner.start <= op.start and op.end <= inner.end
               for op in ops)
    assert outer.start <= inner.start and inner.end <= outer.end


def test_device_spans_record_no_events_on_the_cpu():
    def run():
        with span("deeparc.test.device", device=True):
            torch.ones(8).sum()

    _, _, recs = _profiled(run)
    assert len(recs) == 1 and recs[0]["device_s"] is None
    assert profiling._events == {}


def test_the_record_list_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)

    def run():
        for _ in range(5):
            with span("deeparc.test.many"):
                pass

    _, _, recs = _profiled(run)
    assert len(recs) == 3 and profiling.dropped_spans() == 2
    reset_spans()
    assert spans() == [] and profiling.dropped_spans() == 0


# the span tree of a grid pipeline: each span's parent
GRID_TREE = {
    "deeparc.pipeline": None,
    "deeparc.pipeline.load": "deeparc.pipeline",
    "deeparc.pipeline.hemisphere": "deeparc.pipeline",
    "deeparc.pipeline.layout": "deeparc.pipeline",
    "deeparc.pipeline.solve": "deeparc.pipeline",
    "deeparc.pipeline.filter": "deeparc.pipeline",
    "deeparc.pipeline.sync": "deeparc.pipeline",
    "deeparc.pipeline.compact": "deeparc.pipeline",
    "deeparc.pipeline.final_cost": "deeparc.pipeline",
    "deeparc.solve": "deeparc.pipeline.solve",
    "deeparc.grid.band_prep": "deeparc.solve",
    "deeparc.band.cooc": "deeparc.grid.band_prep",
    "deeparc.band.ordering": "deeparc.grid.band_prep",
    "deeparc.band.tiles": "deeparc.grid.band_prep",
    "deeparc.band.permute": "deeparc.grid.band_prep",
    "deeparc.band.stacks": "deeparc.grid.band_prep",
    "deeparc.grid.step_build": "deeparc.solve",
    "deeparc.grid.init": "deeparc.solve",
    "deeparc.lm_loop": "deeparc.solve",
    "deeparc.grid.unpermute": "deeparc.solve",
    "deeparc.lm.sync": "deeparc.lm_loop",
    "deeparc.lm.step": "deeparc.lm_loop",
    "deeparc.grid.linearize": "deeparc.lm.step",
    "deeparc.grid.schur": "deeparc.lm.step",
    "deeparc.grid.trial_cost": "deeparc.lm.step",
}


def test_a_grid_pipeline_leaves_the_span_tree():
    rig = make_hemisphere_rig(**BANDED_RIG)
    res, _, recs = _profiled(lambda: run_pipeline(
        rig.data, PipelineOptions(), device="cpu", verbose=False))
    by_id = {r["id"]: r for r in recs}
    names = _by_name(recs)
    assert set(names) == set(GRID_TREE)
    root = names["deeparc.pipeline"][0]["id"]
    for r in recs:
        parent = GRID_TREE[r["name"]]
        assert (by_id[r["parent"]]["name"] if r["parent"] else None) == \
            parent, r["name"]
        assert r["root"] == root
    assert len(names["deeparc.lm.step"]) == res.solve_iterations
    assert len(names["deeparc.pipeline.solve"]) == res.filter_rounds + 1
    assert [r["counts"]["round"] for r in names["deeparc.pipeline.solve"]] \
        == list(range(res.filter_rounds + 1))
    # the first solve preps the band, the rounds update it
    assert [r["counts"]["fresh"] for r in names["deeparc.grid.band_prep"]] \
        == [1] + [0] * res.filter_rounds
    assert all(r["counts"]["w_band"] > 0
               for r in names["deeparc.grid.band_prep"])
    last = names["deeparc.pipeline.filter"][-1]["counts"]
    assert last["points_alive"] == res.scene.n_points
    assert last["obs_alive"] == int(res.scene.index.obs_mask.sum())


def test_a_tile_solve_leaves_the_span_tree():
    data = make_bal_synthetic(n_cameras=12, n_points=150, track_length=5.0,
                              pixel_noise=0.5, point_noise=0.03,
                              seed=3).data
    scene = from_deeparc(data, device="cpu")
    free = freeze_masks(scene)
    tiles, params_t, free_t = tt.tiles_from_scene(scene, free,
                                                  chunk_obs=256)
    opts = SolverOptions(max_iterations=4, linear_solver="iterative_schur",
                         cg_max_iterations=60, cg_tolerance=1e-3,
                         progress_to_stdout=False)
    res, _, recs = _profiled(lambda: tt.solve_tiles_prepared(
        params_t, tiles, free_t, flatten_camera(free), opts))
    by_id = {r["id"]: r for r in recs}
    names = _by_name(recs)
    assert set(names) == {
        "deeparc.solve", "deeparc.tiles.step_build", "deeparc.tiles.init",
        "deeparc.lm_loop", "deeparc.lm.sync", "deeparc.lm.step",
        "deeparc.tiles.linearize", "deeparc.tiles.pcg",
        "deeparc.tiles.trial_cost"}
    assert len(names["deeparc.solve"]) == 1
    root = names["deeparc.solve"][0]["id"]
    assert all(r["root"] == root for r in recs)
    for name in ("deeparc.tiles.linearize", "deeparc.tiles.pcg",
                 "deeparc.tiles.trial_cost"):
        assert all(by_id[r["parent"]]["name"] == "deeparc.lm.step"
                   for r in names[name])
    assert len(names["deeparc.lm.step"]) == res.iterations >= 1
    assert sum(r["counts"]["iterations"] for r in names["deeparc.tiles.pcg"]) \
        == res.cg_iterations > 0


def test_trace_to_writes_the_span_report(tmp_path):
    from deeparc_tpu_torch.utils import trace_to

    def before():
        with span("deeparc.test.before"):
            pass

    _profiled(before)       # a record from before the block
    with trace_to(str(tmp_path)) as prof:
        with span("deeparc.test.traced", n=4):
            torch.ones(4).sum()
    with open(prof.span_report_path) as f:
        rep = json.load(f)
    assert prof.span_report_path.startswith(str(tmp_path))
    assert rep["dropped"] == 0
    assert set(rep["spans"]) == {"deeparc.test.traced"}
    assert rep["spans"]["deeparc.test.traced"]["count"] == 1
    assert rep["spans"]["deeparc.test.traced"]["counts"] == {"n": 4}

"""The span readers (``portbench/spans.py`` and the eight metrics that
read the program's spans or the idle attribution by them) on hand-built
records and profiles, and on a tiny cell's call traced on the CPU."""

import pytest

from portbench.run import load_module
from portbench.tests.conftest import TINY


class Recs:
    """Hand-built span records: ``add`` opens a closed span under
    ``parent`` (a record) lasting ``ms`` from ``at`` ms."""

    def __init__(self):
        self.out = []

    def add(self, name, parent=None, at=0.0, ms=1.0, device_s=None,
            **counts):
        rid = len(self.out) + 1
        rec = {"id": rid, "parent": parent and parent["id"],
               "root": parent["root"] if parent else rid, "name": name,
               "start_ns": int(at * 1e6), "end_ns": int((at + ms) * 1e6),
               "counts": counts, "device_s": device_s}
        self.out.append(rec)
        return rec


@pytest.fixture
def given(monkeypatch):
    """Make the program's ``spans()`` return a ``Recs``' records."""
    from deeparc_tpu_torch.utils import profiling

    recs = Recs()
    monkeypatch.setattr(profiling, "spans", lambda: list(recs.out))
    return recs


def read(name, rec=None):
    return load_module("metrics", name).read(rec or {"unit": "solve",
                                                     "profile": None})


def _grid_solve(r, at, prep_ms, schur_s, steps):
    root = r.add("deeparc.solve", at=at, ms=100)
    r.add("deeparc.grid.band_prep", root, at=at, ms=prep_ms, fresh=1)
    loop = r.add("deeparc.lm_loop", root, at=at + 50, ms=40)
    for k in range(steps):
        step = r.add("deeparc.lm.step", loop, at=at + 50 + 10 * k, ms=9)
        r.add("deeparc.grid.schur", step, at=at + 51 + 10 * k, ms=3,
              device_s=schur_s)


def test_grid_solve_readers(given):
    _grid_solve(given, 0, 30.0, 0.012, 3)
    _grid_solve(given, 200, 50.0, 0.010, 2)
    # a probe's parts, below no root: not read
    given.add("deeparc.grid.band_prep", ms=500.0)
    given.add("deeparc.grid.schur", ms=1.0, device_s=1.0)
    assert read("band_prep_ms") == pytest.approx(40.0)
    assert read("schur_iter_ms") == pytest.approx(
        (3 * 12.0 + 2 * 10.0) / 5)


def test_grid_readers_without_device_time_or_steps(given):
    _grid_solve(given, 0, 30.0, None, 2)
    assert read("band_prep_ms") == pytest.approx(30.0)
    assert read("schur_iter_ms") is None        # no card: no device time


def test_tile_pcg_reader(given):
    for at, its in ((0, (30, 30)), (100, (12,))):
        root = given.add("deeparc.solve", at=at, ms=90)
        loop = given.add("deeparc.lm_loop", root, at=at, ms=80)
        for k, n in enumerate(its):
            step = given.add("deeparc.lm.step", loop, at=at + 20 * k, ms=19)
            given.add("deeparc.tiles.pcg", step, at=at + 20 * k, ms=10,
                      device_s=0.004 * n, iterations=n)
    assert read("pcg_sweep_ms") == pytest.approx(4.0)
    assert read("band_prep_ms") is None         # no band prep span


def test_pipeline_readers(given):
    for at in (0, 1000):
        root = given.add("deeparc.pipeline", at=at, ms=900)
        given.add("deeparc.pipeline.load", root, at=at, ms=100)
        given.add("deeparc.pipeline.layout", root, at=at + 100, ms=50)
        for k in range(2):
            given.add("deeparc.pipeline.filter", root, at=at + 300 + k * 200,
                      ms=60, obs_alive=10, points_alive=5)
            given.add("deeparc.pipeline.sync", root, at=at + 360 + k * 200,
                      ms=20)
        solve = given.add("deeparc.pipeline.solve", root, at=at + 700,
                          ms=100, round=1)
        given.add("deeparc.solve", solve, at=at + 700, ms=100)
    assert read("pipeline_load_s") == pytest.approx(0.150)
    assert read("pipeline_filter_s") == pytest.approx(0.160)
    # a solve inside a pipeline is no solve root
    assert read("band_prep_ms") is None


def test_no_rooted_records_read_none(given):
    given.add("deeparc.grid.band_prep", ms=5.0)
    given.add("deeparc.tiles.pcg", ms=5.0, device_s=0.1, iterations=3)
    given.add("deeparc.pipeline.load", ms=5.0)
    for name in ("band_prep_ms", "schur_iter_ms", "pcg_sweep_ms",
                 "pipeline_load_s", "pipeline_filter_s"):
        assert read(name) is None, name


def _profiled_rec(unit, gaps, window=2.0, busy=1.0):
    return {"unit": unit, "profile": {"window_s": window, "busy_s": busy,
                                      "idle_gaps": gaps}}


@pytest.mark.parametrize("name,unit", [
    ("idle_unnamed_share", "solve"), ("idle_unnamed_share.tiles", "solve"),
    ("idle_unnamed_share.pipeline", "pipeline")])
def test_unnamed_share(name, unit):
    other = "pipeline" if unit == "solve" else "solve"
    gaps = [["host work outside traced ops", 0.25], ["deeparc.lm_loop", 0.1]]
    assert read(name, _profiled_rec(unit, gaps)) == pytest.approx(0.25)
    assert read(name, _profiled_rec(other, gaps)) is None
    assert read(name, {"unit": unit, "profile": None}) is None
    # absent from fewer than ten: none unnamed
    assert read(name, _profiled_rec(unit, gaps[1:])) == 0.0
    # absent from the ten largest: the tenth's value bounds it
    ten = [[f"deeparc.x{i}", 0.1 - 0.005 * i] for i in range(10)]
    assert read(name, _profiled_rec(unit, ten)) == pytest.approx(0.055)


def _traced_call(workload):
    """One call of a tiny cell's entry on the CPU under the profiler, from
    no span records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeparc_tpu_torch.utils.profiling import reset_spans
    from portbench import answers, generate
    from portbench.run import load_cell

    _, _, cell, cfg, traffic = load_cell(workload, TINY[workload])
    dev = torch.device("cpu")
    data = generate.make(cfg, traffic, 2 ** 31 + 5, dev)
    ctx = {"config": cfg, "traffic": traffic, "cell": cell, "data": data,
           "device": dev, "seed": 2 ** 31 + 5,
           "start": answers.start_of(data, cfg.get("free_intrinsics", ()))}
    entry = load_module("entries", cell["entry"])
    state = entry.setup(ctx)
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        return entry.call(state)


def test_tiny_cells_traced_on_the_cpu_read_their_spans():
    out = _traced_call("rig-occl.solve")
    assert out["iterations"] >= 1
    assert read("band_prep_ms") > 0
    # the CPU has no device clock: the device readers read nothing
    assert read("schur_iter_ms") is None
    _traced_call("rig-occl.pipeline")
    assert read("pipeline_load_s") > 0
    assert read("pipeline_filter_s") > 0
    assert read("band_prep_ms") is None
    out = _traced_call("bal-venice.solve")
    assert out["cg_iterations"] > 0
    assert read("pcg_sweep_ms") is None

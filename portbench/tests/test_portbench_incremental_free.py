"""The incremental reconstruction of independent cameras and the BAL solve
without locality as tiny cells through the program's plain paths on the
CPU: both correct, the readers of the incremental cell's counters, and
the control refused on both."""

import pytest

from portbench.control import control_gaps
from portbench.run import load_cell, run_cell

# the two cells cut to a size the CPU solves in seconds; the widths (the
# cameras' parameters, the track law) stay the files'
TINY = {
    "bal-venice.incremental": {
        "config": {"n_cameras": 12, "n_points": 300, "n_observations": 900,
                   "incremental": {"batch_size": 3, "order": "bfs",
                                   "start_camera": 0, "min_observations": 2,
                                   "pose_graph": True, "min_covis": 3,
                                   "pose_graph_iterations": 20}},
        "traffic": {"window": 6, "track_clip": 12}},
    "bal-venice.nolocal.solve": {
        "config": {"n_cameras": 40, "n_points": 600,
                   "n_observations": 3000},
        "traffic": {"window": 40, "track_clip": 40}},
}


@pytest.mark.parametrize("workload", sorted(TINY))
def test_tiny_cell_is_correct(workload):
    out = run_cell(workload, 2 ** 31 + 11, 0.2, False, device="cpu",
                   overrides=TINY[workload])
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]
    key = ("pipeline_s" if workload.endswith("incremental")
           else "solve_s.tiles")
    assert out["metrics"][key]["value"] > 0
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name


def test_traced_incremental_cell_reads_its_counters():
    out = run_cell("bal-venice.incremental", 5, 0.2, True, device="cpu",
                   overrides=TINY["bal-venice.incremental"])
    assert out["correct"]
    got = out["metrics"]
    assert got["incremental_lm_iter_ms"]["value"] > 0
    assert got["pipeline_host_s"]["value"] > 0
    # the span readers need a profiled sub-window, which runs on a card
    for name in ("pose_graph_iter_ms", "incremental_edges_ms",
                 "incremental_batch_ms", "incremental_load_s"):
        assert name not in got
    assert out["checks"]["order_mismatch"]["value"] == 0.0
    assert out["checks"]["edges_mismatch"]["value"] == 0.0


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_is_refused(workload):
    limits = load_cell(workload)[2]["limits"]
    gaps = control_gaps(workload, 7, "cpu", TINY[workload])
    assert any(not v <= limits[k] for k, v in gaps.items()), gaps


def test_the_incremental_reference_imports_nothing_of_the_program():
    from portbench.tests.test_portbench_parts import _fresh_modules

    top = _fresh_modules("import portbench.incremental_free")
    assert not top & {"deeparc_tpu_torch", "deeparc_tpu", "jax"}

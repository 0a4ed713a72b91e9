"""The incremental cell and the uniform rig's solve as tiny cells through
the program's plain paths on the CPU: both correct, the readers of the
incremental cell's counters, and the control refused on the incremental
cell."""

import pytest

from portbench.control import control_gaps
from portbench.run import load_cell, run_cell

# the two cells cut to a size the CPU solves in seconds; the widths stay
# the files'
TINY = {
    "rig-occl.incremental": {
        "config": {"n_arc": 2, "n_ring": 6, "n_points": 300,
                   "incremental": {"batch_size": 6, "order": "bfs",
                                   "start_cell": 0,
                                   "min_observations": 2}},
        "traffic": {"occlusion_rings": 3, "visibility": 0.5}},
    "rig-uniform.solve": {"config": {"n_arc": 4, "n_ring": 8,
                                     "n_points": 400},
                          "traffic": {"visibility": 0.3}},
}


@pytest.mark.parametrize("workload", sorted(TINY))
def test_tiny_cell_is_correct(workload):
    out = run_cell(workload, 2 ** 31 + 11, 0.2, False, device="cpu",
                   overrides=TINY[workload])
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]
    key = "pipeline_s" if workload.endswith("incremental") else "solve_s"
    assert out["metrics"][key]["value"] > 0
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name


def test_traced_incremental_cell_reads_its_counters():
    out = run_cell("rig-occl.incremental", 5, 0.2, True, device="cpu",
                   overrides=TINY["rig-occl.incremental"])
    assert out["correct"]
    got = out["metrics"]
    assert got["incremental_lm_iter_ms"]["value"] > 0
    assert got["pipeline_host_s"]["value"] > 0
    # the span readers need a profiled sub-window, which runs on a card
    assert "incremental_batch_ms" not in got
    assert "incremental_load_s" not in got
    assert out["per_call"]["iterations"][0] > 0


def test_control_is_refused_on_the_incremental_cell():
    limits = load_cell("rig-occl.incremental")[2]["limits"]
    gaps = control_gaps("rig-occl.incremental", 7, "cpu",
                        TINY["rig-occl.incremental"])
    assert any(not v <= limits[k] for k, v in gaps.items()), gaps

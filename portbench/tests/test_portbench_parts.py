"""The harness's parts: files found by name, the result line, no JAX, a
reference that imports nothing of the program, the byte counts and the
idle arithmetic."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import roofline, trace
from portbench.run import HERE, ROOT, forbidden_modules, main

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _names(kind, ext):
    return {f[: -len(ext)] for f in os.listdir(os.path.join(HERE, kind))
            if f.endswith(ext)}


def test_every_file_is_found_by_name():
    from portbench.run import load_json, load_module

    assert _names("configs", ".json") == {c["name"] for c in BENCH["configs"]}
    assert _names("cells", ".json") == {w["name"] for w in BENCH["workloads"]}
    metrics = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    assert _names("metrics", ".py") == metrics
    for m in metrics:
        assert callable(load_module("metrics", m).read)
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert load_json("configs", c["name"])["name"] == c["name"]
    traffics = {w["traffic"] for w in BENCH["workloads"]}
    assert _names("traffic", ".json") == traffics
    for w in BENCH["workloads"]:
        cell = load_json("cells", w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        entry = load_module("entries", cell["entry"])
        assert entry.UNIT == load_json("traffic", w["traffic"])["requests"]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deeparc_tpu_torch.fake", object())
    assert forbidden_modules() == [] or "deeparc_tpu" not in sys.modules
    monkeypatch.setitem(sys.modules, "deeparc_tpu.fake", object())
    assert "deeparc_tpu" in forbidden_modules()


def _fresh_modules(code):
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=ROOT, capture_output=True,
        text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    from portbench.tests.conftest import TINY

    code = ("import torch; torch.set_num_threads(1)\n"
            "from portbench.run import run_cell\n"
            f"run_cell('rig-occl.solve', 1, 0.1, False, device='cpu', "
            f"overrides={TINY['rig-occl.solve']!r})")
    top = _fresh_modules(code)
    assert not top & {"jax", "jaxlib", "flax", "deeparc_tpu"}
    assert "deeparc_tpu_torch" in top


def test_the_reference_imports_nothing_of_the_program():
    top = _fresh_modules("import portbench.reference, portbench.generate, "
                         "portbench.judge, portbench.roofline, "
                         "portbench.trace, portbench.answers")
    assert not top & {"deeparc_tpu_torch", "deeparc_tpu", "jax"}


def test_no_card_exits_without_a_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert main(["--workload", "rig-occl.solve", "--seed", "1",
                 "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def _tiny_rig():
    from portbench.generate import DeepArcArrays

    # 2 arcs x 2 rings: records 0 (gauge), 1 (arc 1), 2 (ring 1); 3 points
    z = np.zeros
    return DeepArcArrays(
        version=0.01, share_extrinsic=True, arc_size=2, ring_size=2,
        obs_arc=np.array([0, 1, 1, 0, 1], np.int32),
        obs_ring=np.array([1, 0, 1, 0, 1], np.int32),
        obs_point=np.array([0, 0, 0, 1, 2], np.int32),
        obs_xy=z((5, 2)), center=z((2, 2)), focal=z((2, 2)),
        focal_size=np.ones(2, np.int32), dist=z((2, 2)),
        dist_size=z(2, np.int32), ext_rot=z((3, 3)), ext_trans=z((3, 3)),
        points=z((3, 3)), colors=z((3, 3), np.int32))


def test_byte_counts_match_a_hand_count():
    data = _tiny_rig()
    free_rows = np.array([0, 1, 1, 0])          # gauge and identity frozen
    work = roofline.pass_work(data, free_rows, np.zeros((2, 6), np.int64))
    # observations: (arc 0, ring 1) -> outer 2, inner identity: 6 free
    # columns; (1, 0) -> outer 1: 6; (1, 1) -> outer 1, inner 2: 12;
    # (0, 0) -> record 0: 0; (1, 1) of point 2: 12
    read = 5 * (16 + 4) + 3 * 24 + (4 * 6 + 2 * 6) * 8
    # E: point 0 touches rows 1, 2 -> 12 columns; point 2 rows 1, 2 -> 12
    e_cols = 24
    # cells (2, 3, 0): 6 free, (1, 3, 1): 6, (1, 2, 1): 12, (0, 3, 0): 0
    cells = 21 + 21 + 78 + 0
    written = (3 * 9 + 3 * e_cols + 12 + cells) * 8
    assert work["linearize"][0] == read + written
    q = np.array([9, 9, 15, 3, 15])
    assert work["linearize"][1] == float((2 * q * (q + 1)).sum())
    assert work["cost"] == (read + 8, 300.0)


@pytest.mark.parametrize("intervals, lo, hi, busy", [
    ([(0, 2), (1, 3), (5, 6)], 0, 10, 4),        # overlap merged
    ([(-5, 1), (9, 20)], 0, 10, 2),              # clipped to the window
    ([(2, 2), (3, 1)], 0, 10, 0),                # empty intervals
    ([(1, 4), (2, 3), (4, 5)], 0, 10, 4),        # nested and touching
    ([], 0, 10, 0),
])
def test_busy_in_hand_cases(intervals, lo, hi, busy):
    assert trace.busy_in(intervals, lo, hi) == busy


def test_idle_share_refuses_readings_from_two_clocks():
    assert trace.idle_share(3.0, 4.0) == 0.25
    assert trace.idle_share(4.0, 4.0) == 0.0
    with pytest.raises(ValueError):
        trace.idle_share(5.0, 4.0)
    with pytest.raises(ValueError):
        trace.idle_share(1.0, 0.0)
    assert trace.gaps_of([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]

"""Tiny cells end to end through the program's plain paths on the CPU:
the result line, the comparison, the readers."""

import pytest

from portbench.run import run_cell
from portbench.tests.conftest import TINY

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("workload", sorted(TINY))
def test_tiny_cell_is_correct(workload):
    out = run_cell(workload, 2 ** 31 + 11, 0.2, False, device="cpu",
                   overrides=TINY[workload])
    assert all(k in out for k in KEYS)
    assert list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert "setup_s" in out["metrics"]
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name


def test_traced_cell_reports_per_layer_metrics():
    out = run_cell("bal-venice.solve", 5, 0.2, True, device="cpu",
                   overrides=TINY["bal-venice.solve"])
    assert out["correct"]
    got = out["metrics"]
    assert got["pcg_per_lm"]["value"] > 0
    assert 0 < got["tile_linearize_roofline"]["value"] <= 100
    assert "linearize_roofline" not in got and "lm_iter_ms" not in got
    assert got["lm_iter_ms.tiles"]["value"] > 0
    assert "setup_s" not in got


def test_same_seed_same_scene_and_other_seed_other_scene():
    import numpy as np
    import torch

    from portbench import generate
    from portbench.run import load_cell

    _, _, _, cfg, traffic = load_cell("bal-venice.solve",
                                   TINY["bal-venice.solve"])
    a, b, c = (generate.make(cfg, traffic, s, torch.device("cpu"))
               for s in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2))
    assert np.array_equal(a.obs_xy, b.obs_xy)
    assert a.n_obs == c.n_obs == cfg["n_observations"]
    assert not np.array_equal(a.obs_xy, c.obs_xy)

"""The comparison that decides ``correct`` refuses the control (the
reference in float32) and the faults of the timed path, at the tiny
cells' size on the CPU."""

import dataclasses

import pytest
import torch

from portbench.control import control_gaps
from portbench.run import load_cell, run_cell
from portbench.tests.conftest import TINY


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_is_refused(workload):
    limits = load_cell(workload)[2]["limits"]
    gaps = control_gaps(workload, 7, "cpu", TINY[workload])
    assert any(not v <= limits[k] for k, v in gaps.items()), gaps


def _unchanged(res, params):
    return res._replace(params=params)


def _half(res, params):
    """Half the points left where they started, as if half the batch had
    been left out of the step."""
    pts = res.params.points.clone()
    n = pts.shape[0] // 2
    pts[n:] = params.points[n:]
    return res._replace(params=dataclasses.replace(res.params, points=pts))


def _altered(res, params):
    """One answer altered where it is produced: one point moved by 1e-3
    (a twentieth of the points' starting noise, a quarter pixel)."""
    pts = res.params.points.clone()
    pts[0, 0] += 1e-3
    return res._replace(params=dataclasses.replace(res.params, points=pts))


def _intrinsics_held(res, params):
    """The intrinsics that the configuration frees left where they
    started."""
    return res._replace(params=dataclasses.replace(
        res.params, focal=params.focal, dist=params.dist))


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}
SOLVERS = {"rig-occl.solve": ("deeparc_tpu_torch.solver.rig_grid",
                              "solve_ba_grid"),
           "bal-venice.solve": ("deeparc_tpu_torch.solver.tiles",
                                "solve_tiles_prepared")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(SOLVERS))
def test_faulty_solve_is_not_correct(workload, fault, monkeypatch):
    import importlib

    mod_name, fn_name = SOLVERS[workload]
    mod = importlib.import_module(mod_name)
    real = getattr(mod, fn_name)

    def broken(params, *args, **kwargs):
        res = real(params, *args, **kwargs)
        if fn_name == "solve_tiles_prepared":
            # the start in the caller's point order, as the solve returns it
            rows = args[0].row_of_point.long()
            params = dataclasses.replace(params, points=params.points[rows])
        return FAULTS[fault](res, params)

    monkeypatch.setattr(mod, fn_name, broken)
    out = run_cell(workload, 3, 0.2, False, device="cpu",
                   overrides=TINY[workload])
    assert not out["correct"] and out["failed"] == out["attempted"]


def test_bal_solve_holding_its_free_intrinsics_is_not_correct(monkeypatch):
    from deeparc_tpu_torch.solver import tiles

    real = tiles.solve_tiles_prepared

    def broken(params, *args, **kwargs):
        return _intrinsics_held(real(params, *args, **kwargs), params)

    monkeypatch.setattr(tiles, "solve_tiles_prepared", broken)
    out = run_cell("bal-venice.solve", 3, 0.2, False, device="cpu",
                   overrides=TINY["bal-venice.solve"])
    assert not out["correct"]
    assert out["checks"]["cameras_gap"]["value"] > 0.1


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_faulty_pipeline_is_not_correct(fault, monkeypatch):
    from deeparc_tpu_torch.pipeline import driver

    real = driver.run_pipeline

    def broken(data, *args, **kwargs):
        res = real(data, *args, **kwargs)
        pts = res.scene.params.points.clone()
        if fault == "unchanged":
            pts = torch.as_tensor(data.points[: pts.shape[0]],
                                  dtype=pts.dtype)
        else:
            pts[0, 0] += 1e-3
        scene = dataclasses.replace(res.scene, params=dataclasses.replace(
            res.scene.params, points=pts))
        return res._replace(scene=scene)

    import deeparc_tpu_torch.pipeline as pipeline_pkg

    monkeypatch.setattr(pipeline_pkg, "run_pipeline", broken)
    out = run_cell("rig-occl.pipeline", 3, 0.2, False, device="cpu",
                   overrides=TINY["rig-occl.pipeline"])
    assert not out["correct"]


@pytest.mark.card
def test_control_is_refused_on_the_card(card):
    """The control at the rig cell's own size on the card, one seed (the
    full check runs three or more with ``python3 -m portbench.control``)."""
    limits = load_cell("rig-occl.solve")[2]["limits"]
    gaps = control_gaps("rig-occl.solve", 11, "cuda")
    assert any(not v <= limits[k] for k, v in gaps.items()), gaps

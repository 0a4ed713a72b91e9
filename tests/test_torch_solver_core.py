"""Ceres' accept-and-stop law, the one every LM step of the port takes
(``deeparc_tpu_torch.solver.trust_region.decide``), on CPU scalars in
float64: the next trust region after an accepted and a rejected step,
and the status precedence gradient (3) > function (2) > parameter (4) >
radius (5) > running (0)."""

import pytest
import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.solver import trust_region as tr_mod

OPTS = SolverOptions()
# a step that decreases the cost from 10 to 8 against a model decrease of
# 2.5 (rho = 0.8), at a large gradient and step: no tolerance holds
BASE = dict(cost=10.0, new_cost=8.0, mcc=2.5, radius=100.0, factor=4.0,
            grad_max=1.0, step_norm=1.0, x_norm=10.0)


def _grown(radius, rho):
    return min(radius / max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
               OPTS.max_radius)


CASES = {
    # accept: the radius grows by 1/max(1/3, 1-(2 rho-1)^3), the decrease
    # factor resets to 2
    "accept": (dict(), True, _grown(100.0, 0.8), 2.0, 0),
    # ... and the growth stops at max_radius
    "accept_capped": (dict(radius=1e16, new_cost=7.5), True, 1e16, 2.0, 0),
    # reject (the cost rose): radius / decrease factor, which doubles
    "reject": (dict(new_cost=11.0), False, 25.0, 8.0, 0),
    # a model that predicts no decrease is never accepted
    "reject_model": (dict(mcc=-1.0), False, 25.0, 8.0, 0),
    # the function and parameter tolerances hold for accepted steps only
    "reject_small": (dict(new_cost=10.0 + 1e-7, step_norm=1e-9), False, 25.0,
                     8.0, 0),
    # the gradient tolerance wins over the function tolerance
    "gtol_over_ftol": (dict(new_cost=10.0 - 1e-7, mcc=1e-7, grad_max=1e-11),
                       True, _grown(100.0, 1.0), 2.0, 3),
    # the function tolerance alone: |change| <= 1e-6 * cost
    "ftol": (dict(new_cost=10.0 - 1e-7, mcc=1e-7), True, _grown(100.0, 1.0),
             2.0, 2),
    # the parameter tolerance alone: |dx| <= 1e-8 (|x| + 1e-8)
    "ptol": (dict(step_norm=1e-9), True, _grown(100.0, 0.8), 2.0, 4),
    # a rejected step below min_radius collapses the trust region
    "radius": (dict(new_cost=11.0, radius=3e-32), False, 7.5e-33, 8.0, 5),
    # the function tolerance wins over the parameter tolerance, and that
    # over the collapse
    "ftol_over_ptol": (dict(new_cost=10.0 - 1e-7, mcc=1e-7, step_norm=1e-9),
                       True, _grown(100.0, 1.0), 2.0, 2),
    "ptol_over_radius": (dict(radius=1e-33, step_norm=1e-9), True,
                         _grown(1e-33, 0.8), 2.0, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decide_takes_ceres_step_and_stop_law(case):
    over, accepted, radius, factor, status = CASES[case]
    v = {**BASE, **over}
    t = lambda x: torch.tensor(x, dtype=torch.float64)
    tr = tr_mod.TRState(radius=t(v["radius"]), decrease_factor=t(v["factor"]))
    accept, tr_next, got, info = tr_mod.decide(
        t(v["cost"]), t(v["new_cost"]), t(v["mcc"]), tr, t(v["grad_max"]),
        t(v["step_norm"]), t(v["x_norm"]), OPTS, cg_iters=7)
    assert bool(accept) is accepted and bool(info.accepted) is accepted
    assert got.dtype == torch.int64 and int(got) == status
    assert float(tr_next.radius) == pytest.approx(radius, rel=1e-15)
    assert float(tr_next.decrease_factor) == factor
    # the info: the next state's cost, the radius the step was taken with
    assert float(info.cost) == (v["new_cost"] if accepted else v["cost"])
    assert float(info.radius) == v["radius"]
    assert float(info.cost_change) == v["cost"] - v["new_cost"]
    assert float(info.rho) == pytest.approx(
        (v["cost"] - v["new_cost"]) / max(v["mcc"], 1e-300), rel=1e-15)
    assert (float(info.grad_max), float(info.step_norm), info.cg_iters) == (
        v["grad_max"], v["step_norm"], 7)

"""Levenberg-Marquardt trust-region control (Ceres-parity step policy),
PyTorch port of ``deeparc_tpu.solver.trust_region``:

  * accept (rho > min_relative_decrease):
        radius <- radius / max(1/3, 1 - (2 rho - 1)^3); decrease_factor <- 2
  * reject: radius <- radius / decrease_factor; decrease_factor <- 2x

:func:`decide` is the accept-and-stop law that every LM step of the port
takes (the grid, tile and indexed engines, their sharded forms and the
small dense LM): the step itself stays each engine's own.

Status codes: 0 running/max-iter, 2 function-tol, 3 gradient-tol,
4 parameter-tol, 5 trust region collapsed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeparc_tpu_torch.device import check_device


class StepInfo(NamedTuple):
    cost: torch.Tensor
    cost_change: torch.Tensor
    grad_max: torch.Tensor
    step_norm: torch.Tensor
    radius: torch.Tensor
    rho: torch.Tensor
    accepted: torch.Tensor
    # PCG iterations the linear solve used (the tile engine's
    # ITERATIVE_SCHUR; -1 where the solve is direct)
    cg_iters: int = -1


class TRState(NamedTuple):
    radius: torch.Tensor           # scalar
    decrease_factor: torch.Tensor  # scalar, doubles on consecutive rejects


def init_tr(radius: float, dtype=torch.float64, device="cuda") -> TRState:
    device = check_device(device)
    return TRState(radius=torch.tensor(radius, dtype=dtype, device=device),
                   decrease_factor=torch.tensor(2.0, dtype=dtype,
                                                device=device))


def step_accepted(tr: TRState, rho: torch.Tensor, max_radius: float) -> TRState:
    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    return TRState(radius=torch.clamp(tr.radius / shrink, max=max_radius),
                   decrease_factor=torch.full_like(tr.decrease_factor, 2.0))


def step_rejected(tr: TRState) -> TRState:
    return TRState(radius=tr.radius / tr.decrease_factor,
                   decrease_factor=tr.decrease_factor * 2.0)


def select(accept: torch.Tensor, a: TRState, b: TRState) -> TRState:
    """Elementwise ``accept ? a : b`` over the state's fields."""
    return TRState(*(torch.where(accept, x, y) for x, y in zip(a, b)))


def decide(cost, new_cost, mcc, tr: TRState, grad_max, step_norm, x_norm,
           options, cg_iters=-1):
    """Ceres' decision on one LM step, from the current ``cost``, the
    trial's ``new_cost`` and the model cost change ``mcc``: the gain ratio
    rho, the accept test, the next trust region and the status, the
    tolerances tested against the current iterate (``grad_max`` = max |g|,
    ``step_norm`` = |dx|, ``x_norm`` = |x|, each engine's own reductions)
    with the precedence gradient > function > parameter > radius. All of
    it stays on the device. Returns (accept, next trust region, status,
    StepInfo); the info's cost is the next state's, its radius the one
    the step was taken with."""
    rho = (cost - new_cost) / torch.clamp(mcc, min=1e-300)
    accept = (mcc > 0) & (rho > options.min_relative_decrease)
    tr_next = select(accept, step_accepted(tr, rho, options.max_radius),
                     step_rejected(tr))
    cost_change = cost - new_cost
    ftol = accept & (torch.abs(cost_change)
                     <= options.function_tolerance * cost)
    ptol = accept & (step_norm <= options.parameter_tolerance
                     * (x_norm + options.parameter_tolerance))
    gtol = grad_max <= options.gradient_tolerance
    radius_min = tr_next.radius <= options.min_radius
    zero = torch.zeros((), dtype=torch.int64, device=cost.device)
    status = torch.where(gtol, 3, torch.where(ftol, 2, torch.where(
        ptol, 4, torch.where(radius_min, 5, zero))))
    info = StepInfo(cost=torch.where(accept, new_cost, cost),
                    cost_change=cost_change, grad_max=grad_max,
                    step_norm=step_norm, radius=tr.radius, rho=rho,
                    accepted=accept, cg_iters=cg_iters)
    return accept, tr_next, status, info


def lm_diagonal(jtj_diag: torch.Tensor, min_diag: float,
                max_diag: float) -> torch.Tensor:
    """Ceres' clamped LM scaling diagonal D^2 = clamp(diag(J^T J))."""
    return torch.clamp(jtj_diag, min_diag, max_diag)


def model_cost_change(j_dx: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """m(0) - m(dx) for m(dx) = 0.5 || r + J dx ||^2."""
    return -(torch.dot(r, j_dx) + 0.5 * torch.dot(j_dx, j_dx))

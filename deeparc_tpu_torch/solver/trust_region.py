"""Levenberg-Marquardt trust-region control (Ceres-parity step policy),
PyTorch port of ``deeparc_tpu.solver.trust_region``:

  * accept (rho > min_relative_decrease):
        radius <- radius / max(1/3, 1 - (2 rho - 1)^3); decrease_factor <- 2
  * reject: radius <- radius / decrease_factor; decrease_factor <- 2x
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeparc_tpu_torch.device import check_device


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


def lm_diagonal(jtj_diag: torch.Tensor, min_diag: float,
                max_diag: float) -> torch.Tensor:
    """Ceres' clamped LM scaling diagonal D^2 = clamp(diag(J^T J))."""
    return torch.clamp(jtj_diag, min_diag, max_diag)


def model_cost_change(j_dx: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """m(0) - m(dx) for m(dx) = 0.5 || r + J dx ||^2."""
    return -(torch.dot(r, j_dx) + 0.5 * torch.dot(j_dx, j_dx))

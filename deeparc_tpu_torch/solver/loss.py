"""Robust losses (Ceres' definitions), PyTorch port of
``deeparc_tpu.solver.loss``. s = ||r||^2 is robustified to rho(s); residuals
and Jacobian rows are scaled by w = sqrt(rho'(s)).

  trivial: rho(s) = s
  huber:   rho(s) = s for s <= a^2, else 2 a sqrt(s) - a^2
  cauchy:  rho(s) = a^2 log(1 + s/a^2)
"""

from __future__ import annotations

import torch


def rho(s: torch.Tensor, loss: str, scale: float) -> torch.Tensor:
    if loss == "trivial":
        return s
    a2 = scale * scale
    if loss == "huber":
        return torch.where(s <= a2, s,
                           2.0 * scale * torch.sqrt(torch.clamp(s, min=a2)) - a2)
    if loss == "cauchy":
        return a2 * torch.log1p(s / a2)
    raise ValueError(f"unknown loss {loss!r}")


def weight(s: torch.Tensor, loss: str, scale: float) -> torch.Tensor:
    """w = sqrt(rho'(s))."""
    if loss == "trivial":
        return torch.ones_like(s)
    a2 = scale * scale
    if loss == "huber":
        return torch.where(
            s <= a2, torch.ones_like(s),
            torch.sqrt(scale / torch.sqrt(torch.clamp(s, min=a2))))
    if loss == "cauchy":
        return torch.sqrt(1.0 / (1.0 + s / a2))
    raise ValueError(f"unknown loss {loss!r}")

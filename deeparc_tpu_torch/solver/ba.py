"""Solver records shared by the engines (the ``StepInfo`` / ``BAResult``
of ``deeparc_tpu.solver.ba``). Status codes: 0 running/max-iter,
2 function-tol, 3 gradient-tol, 4 parameter-tol, 5 trust region collapsed."""

from __future__ import annotations

from typing import NamedTuple

import torch

from deeparc_tpu_torch.scene import BAParams


class StepInfo(NamedTuple):
    cost: torch.Tensor
    cost_change: torch.Tensor
    grad_max: torch.Tensor
    step_norm: torch.Tensor
    radius: torch.Tensor
    rho: torch.Tensor
    accepted: torch.Tensor


class BAResult(NamedTuple):
    params: BAParams
    cost: float
    iterations: int
    status: int
    # wall-clock seconds of the LM loop (every step ends in a host sync)
    seconds: float = 0.0

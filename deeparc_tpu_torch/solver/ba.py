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
    # PCG iterations the linear solve used (the tile engine's
    # ITERATIVE_SCHUR; -1 where the solve is direct)
    cg_iters: int = -1


class BAResult(NamedTuple):
    params: BAParams
    cost: float
    iterations: int
    status: int
    # wall-clock seconds of the LM loop (every step ends in a host sync)
    seconds: float = 0.0
    # PCG iterations over the solve (the tile engine's ITERATIVE_SCHUR)
    cg_iterations: int = 0

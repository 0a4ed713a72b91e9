"""Generic dense Levenberg-Marquardt for small problems, PyTorch port of
``deeparc_tpu.solver.lm``. In the pipeline it runs the hemisphere prior fit
(reference ``src/sfm.cc:89-103``: up to 1000 iterations over 4 parameters).
A Python loop takes the place of the reference's ``lax.while_loop``.

Each step takes Ceres' decision through ``trust_region.decide``, the law
of the port's BA engines too, and the loop reads its status once an
iteration. Status codes: ``solver/trust_region.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.solver import trust_region as tr_mod
from deeparc_tpu_torch.solver.linalg import masked_spd_solve


class LMResult(NamedTuple):
    x: torch.Tensor
    cost: torch.Tensor
    iterations: int
    status: int


def levenberg_marquardt(residual_fn: Callable, x0: torch.Tensor,
                        options: SolverOptions = SolverOptions(),
                        free_mask: torch.Tensor | None = None,
                        *aux) -> LMResult:
    """Minimize 0.5 ||residual_fn(x, *aux)||^2 over free coordinates of x."""
    free = (torch.ones_like(x0) if free_mask is None
            else free_mask.to(x0.dtype))

    def cost_of(x):
        r = residual_fn(x, *aux)
        return 0.5 * torch.dot(r, r)

    x = x0
    cost = cost_of(x)
    tr = tr_mod.init_tr(options.initial_radius, x0.dtype, x0.device)
    k, status = 0, 0
    while status == 0 and k < options.max_iterations:
        r = residual_fn(x, *aux)
        J = torch.func.jacfwd(residual_fn)(x, *aux) * free[None, :]
        g = J.T @ r
        jtj = J.T @ J
        d2 = tr_mod.lm_diagonal(torch.diagonal(jtj), options.min_lm_diagonal,
                                options.max_lm_diagonal)
        dx = masked_spd_solve(jtj + torch.diag(d2) / tr.radius, -g, free)
        mcc = tr_mod.model_cost_change(J @ dx, r)
        x_new = x + dx
        new_cost = cost_of(x_new)
        accept, tr, code, info = tr_mod.decide(
            cost, new_cost, mcc, tr, torch.max(torch.abs(g * free)),
            torch.linalg.norm(dx), torch.linalg.norm(x), options)
        x = torch.where(accept, x_new, x)
        cost = info.cost
        k += 1
        status = int(code)
    return LMResult(x=x, cost=cost, iterations=k, status=status)


def fit_hemisphere(camera_centers: torch.Tensor,
                   max_iterations: int = 1000) -> torch.Tensor:
    """Fit the hemisphere prior to camera centers (reference
    ``src/sfm.cc:86-103``). Returns [cx, cy, cz, r^2]; starts at center 0,
    radius 1 (``src/sfm.cc:87-88``)."""
    from deeparc_tpu_torch.residuals.hemisphere import hemisphere_residuals

    x0 = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=camera_centers.dtype,
                      device=camera_centers.device)
    result = levenberg_marquardt(hemisphere_residuals, x0,
                                 SolverOptions(max_iterations=max_iterations),
                                 None, camera_centers)
    return result.x

"""Small batched linear algebra, PyTorch port of the parts of
``deeparc_tpu.solver.linalg`` the engines use: closed-form batched 3x3
inverses for the point-block eliminations, the masked Cholesky solve of the
grid engine's reduced camera system, and the matrix-free PCG of the tile
engine's ITERATIVE_SCHUR."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of (..., 3, 3) via the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
    A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
    A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = torch.stack([torch.stack([A11, A12, A13], dim=-1),
                       torch.stack([A21, A22, A23], dim=-1),
                       torch.stack([A31, A32, A33], dim=-1)], dim=-2)
    return adj * (1.0 / det)[..., None, None]


def masked_spd_solve(A: torch.Tensor, b: torch.Tensor,
                     free: torch.Tensor) -> torch.Tensor:
    """Solve A x = b over the free coordinates; frozen coordinates get x = 0
    (frozen rows/columns replaced by identity, ``src/sfm.cc:50-63``)."""
    free = free.to(A.dtype)
    A_m = A * (free[:, None] * free[None, :]) + torch.diag(1.0 - free)
    # cholesky_ex does not synchronise; a failed factorisation yields NaN
    # (as the reference's Cholesky does), which the LM accept test rejects
    L, info = torch.linalg.cholesky_ex(A_m)
    x = torch.cholesky_solve((b * free)[:, None], L)[:, 0]
    return torch.where(info == 0, x * free, torch.full_like(x, float("nan")))


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
        precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
        max_iterations: int = 500, tol: float = 1e-10) -> CGResult:
    """Matrix-free preconditioned conjugate gradient for A x = b, ``matvec``
    applying the SPD operator A (the Schur complement, never formed).

    A Python loop with the reference's stopping rule: iterate while
    ||r||^2 > (tol ||b||)^2 and fewer than ``max_iterations`` steps were
    taken; the test reads one scalar back from the device per iteration."""
    if precond is None:
        precond = lambda v: v
    atol2 = (tol * torch.linalg.norm(b)) ** 2
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < max_iterations and bool(torch.dot(r, r) > atol2):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        alpha = torch.where(denom > 0, rz / denom, torch.zeros_like(rz))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = torch.where(rz > 0, rz_new / rz, torch.zeros_like(rz))
        p = z + beta * p
        rz = rz_new
        k += 1
    return CGResult(x=x, iterations=k, residual_norm=torch.linalg.norm(r))

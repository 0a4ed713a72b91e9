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
    return spd_solve(A_m, b * free) * free


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a symmetric positive definite A by Cholesky; a
    failed factorisation gives NaN everywhere."""
    # cholesky_ex does not synchronise; a failed factorisation yields NaN
    # (as the reference's Cholesky does), which the LM accept test rejects.
    # Two triangular solves, not cholesky_solve: on the card that one
    # allocates stream-ordered memory, which a CUDA graph's loop body
    # cannot hold.
    L, info = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.mH, y, upper=True)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


class CGResult(NamedTuple):
    x: torch.Tensor
    iterations: int | torch.Tensor
    residual_norm: torch.Tensor


def _cg_start(b, precond, tol):
    """(atol2, x, r, p, rz) before the first iteration."""
    atol2 = (tol * torch.linalg.norm(b)) ** 2
    z = precond(b)
    return atol2, torch.zeros_like(b), b, z, torch.dot(b, z)


def _cg_iteration(matvec, precond, x, r, p, rz):
    """One PCG iteration: the next (x, r, p, rz)."""
    Ap = matvec(p)
    denom = torch.dot(p, Ap)
    alpha = torch.where(denom > 0, rz / denom, torch.zeros_like(rz))
    x = x + alpha * p
    r = r - alpha * Ap
    z = precond(r)
    rz_new = torch.dot(r, z)
    beta = torch.where(rz > 0, rz_new / rz, torch.zeros_like(rz))
    return x, r, z + beta * p, rz_new


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
        precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
        max_iterations: int = 500, tol: float = 1e-10) -> CGResult:
    """Matrix-free preconditioned conjugate gradient for A x = b, ``matvec``
    applying the SPD operator A (the Schur complement, never formed).

    A Python loop with the reference's stopping rule: iterate while
    ||r||^2 > (tol ||b||)^2 and fewer than ``max_iterations`` steps were
    taken; the test reads one scalar back from the device per iteration.
    The plain version of :func:`pcg_device`."""
    if precond is None:
        precond = lambda v: v
    atol2, x, r, p, rz = _cg_start(b, precond, tol)
    k = 0
    while k < max_iterations and bool(torch.dot(r, r) > atol2):
        x, r, p, rz = _cg_iteration(matvec, precond, x, r, p, rz)
        k += 1
    return CGResult(x=x, iterations=k, residual_norm=torch.linalg.norm(r))


def pcg_device(matvec: Callable[[torch.Tensor], torch.Tensor],
               b: torch.Tensor,
               precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
               max_iterations: int = 500, tol: float = 1e-10) -> CGResult:
    """:func:`pcg` with its loop on the device: a WHILE loop
    (``kernels.graph_loop.while_loop``, a conditional graph node inside a
    capture) whose flag is the same stopping test, over buffers that each
    iteration's results are copied into; the iteration count stays a
    device tensor. The same ops in the same order as :func:`pcg`, so the
    same iterates bit for bit."""
    from deeparc_tpu_torch.kernels.graph_loop import while_loop

    if precond is None:
        precond = lambda v: v
    atol2, x, r, p, rz = _cg_start(b, precond, tol)
    x, r, p, rz = (t.clone() for t in (x, r, p, rz))
    k = torch.zeros((), dtype=torch.int64, device=b.device)

    def body():
        for buf, new in zip((x, r, p, rz),
                            _cg_iteration(matvec, precond, x, r, p, rz)):
            buf.copy_(new)
        k.add_(1)

    while_loop(lambda: (k < max_iterations) & (torch.dot(r, r) > atol2),
               body)
    return CGResult(x=x, iterations=k, residual_norm=torch.linalg.norm(r))

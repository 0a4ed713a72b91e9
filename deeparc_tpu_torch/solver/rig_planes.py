"""Plane-form residual chain for the dense grid, PyTorch port of
``deeparc_tpu.solver.rig_planes._project_planes`` (the grid filter's
residual evaluator). Every intermediate is an (N, T) plane."""

from __future__ import annotations


def _project_planes(points, sp, xy0, xy1, mask):
    """Shared residual-chain planes. Returns a dict of (N, T) planes."""
    X = [points[:, i:i + 1] for i in range(3)]                # (N, 1)
    Ri = [[sp.R_i[:, a, b][None, :] for b in range(3)] for a in range(3)]
    Ro = [[sp.R_o[:, a, b][None, :] for b in range(3)] for a in range(3)]
    ti = [sp.t_i[:, a][None, :] for a in range(3)]
    to = [sp.t_o[:, a][None, :] for a in range(3)]
    p2 = [X[0] * Ri[a][0] + X[1] * Ri[a][1] + X[2] * Ri[a][2] + ti[a]
          for a in range(3)]
    p3 = [p2[0] * Ro[a][0] + p2[1] * Ro[a][1] + p2[2] * Ro[a][2] + to[a]
          for a in range(3)]
    inv_z = 1.0 / p3[2]
    u0, u1 = p3[0] * inv_z, p3[1] * inv_z
    r2 = u0 * u0 + u1 * u1
    dcoef = 1.0 + r2 * (sp.d0[None, :] + sp.d1[None, :] * r2)
    r0 = (sp.fx[None, :] * dcoef * u0 + sp.center[:, 0][None, :] - xy0) * mask
    r1 = (sp.fy[None, :] * dcoef * u1 + sp.center[:, 1][None, :] - xy1) * mask
    return dict(X=X, p2=p2, inv_z=inv_z, u0=u0, u1=u1, r2=r2, dcoef=dcoef,
                r0=r0, r1=r1)

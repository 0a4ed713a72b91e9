"""The plain reference: bundle adjustment of a ``.deeparc`` scene written
from the reference's description in plain PyTorch, independent of the
program under test (it imports nothing of it and takes nothing it made).

  * the wiring of observations to extrinsic records and intrinsics
    (``src/DeepArcManager.cc:166-196``) and the Snavely projection through
    composed extrinsics (``src/snavely_reprojection_error.hh:38-118``);
  * Jacobians by forward-mode automatic differentiation of that residual,
    one observation block at a time;
  * Levenberg-Marquardt with Ceres' trust-region policy and stopping rules,
    the point blocks eliminated (Schur): the reduced camera system solved
    densely by Cholesky (DENSE_SCHUR, ``src/sfm.cc:67``), or by PCG with a
    6x6 block-Jacobi preconditioner of the camera Gram (ITERATIVE_SCHUR);
  * the hemisphere fit (``src/sfm.cc:86-103``), the outlier filter
    (``DeepArcManager::filterPoint3d``) and the solve/filter loop
    (``src/sfm.cc:77-131``).

Every function takes a ``dtype``: float64 is the reference; float32 is
the control, the precision below the configuration's, which the
comparison has to refuse. TF32 stays off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK = 1 << 20        # observations per block of the Jacobian passes


@dataclasses.dataclass
class Problem:
    """A scene's tensors: ``ext`` rows (E + 1, 6) as [angle-axis, t] with
    the frozen identity row last, ``intr`` (K, 6) as [cx, cy, fx, fy, k1,
    k2]; per observation its point, outer and inner extrinsic rows and
    intrinsic; per intrinsic its focal sharing and distortion order."""

    points: torch.Tensor
    ext: torch.Tensor
    intr: torch.Tensor
    obs_point: torch.Tensor
    obs_outer: torch.Tensor
    obs_inner: torch.Tensor
    obs_intr: torch.Tensor
    obs_xy: torch.Tensor
    focal_shared: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor

    @property
    def n_cols(self) -> int:
        return 6 * (self.ext.shape[0] + self.intr.shape[0])


def wiring(data) -> tuple:
    """(outer, inner, intr) rows of each observation, as the ``.deeparc``
    format defines them: in a shared rig ring r > 0 lives at record
    r + n_arc - 1, a cell on ring 0 or arc 0 has one extrinsic (the inner
    slot is the identity row E), others compose arc after ring; without
    sharing the columns are (intrinsic, extrinsic)."""
    E = data.ext_rot.shape[0]
    arc = data.obs_arc.astype(np.int64)
    ring = data.obs_ring.astype(np.int64)
    if data.share_extrinsic:
        rec = np.where(ring == 0, 0, ring + data.arc_size - 1)
        outer = np.where(ring == 0, arc, np.where(arc == 0, rec, arc))
        inner = np.where((ring == 0) | (arc == 0), E, rec)
        return outer, inner, arc
    return ring, np.full_like(ring, E), arc


def problem(data, dtype, device) -> Problem:
    outer, inner, intr = wiring(data)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device
                                  ).to(dtype)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    ext = np.concatenate([np.concatenate([data.ext_rot, data.ext_trans], 1),
                          np.zeros((1, 6))])
    return Problem(
        points=f(data.points), ext=f(ext),
        intr=f(np.concatenate([data.center, data.focal, data.dist], 1)),
        obs_point=i64(data.obs_point), obs_outer=i64(outer),
        obs_inner=i64(inner), obs_intr=i64(intr), obs_xy=f(data.obs_xy),
        focal_shared=f(data.focal_size == 1), m1=f(data.dist_size >= 1),
        m2=f(data.dist_size == 2))


def rotate(aa, p):
    """Rodrigues (Ceres' ``AngleAxisRotatePoint``, first order below an
    angle of 1e-12)."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 < 1e-24
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    w = aa / theta
    c, s = torch.cos(theta), torch.sin(theta)
    wp = torch.sum(w * p, dim=-1, keepdim=True)
    large = c * p + s * torch.linalg.cross(w, p) + (1.0 - c) * wp * w
    return torch.where(small, p + torch.linalg.cross(aa, p), large)


def _residual(X, eo, ei, k, xy, fs, m1, m2):
    p = rotate(eo[:, :3], rotate(ei[:, :3], X) + ei[:, 3:]) + eo[:, 3:]
    xp, yp = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
    fx = k[:, 2]
    fy = torch.where(fs > 0.5, k[:, 2], k[:, 3])
    r2 = xp * xp + yp * yp
    d = 1.0 + r2 * (k[:, 4] * m1 + k[:, 5] * m2 * r2)
    return torch.stack([fx * d * xp + k[:, 0] - xy[:, 0],
                        fy * d * yp + k[:, 1] - xy[:, 1]], dim=1)


def _args(prob, points, ext, intr, sl):
    ki = prob.obs_intr[sl]
    return (points[prob.obs_point[sl]], ext[prob.obs_outer[sl]],
            ext[prob.obs_inner[sl]], intr[ki], prob.obs_xy[sl],
            prob.focal_shared[ki], prob.m1[ki], prob.m2[ki])


def _blocks(M):
    return [slice(a, min(a + BLOCK, M)) for a in range(0, M, BLOCK)]


def residuals(prob, points, ext, intr, obs_mask) -> torch.Tensor:
    """(M, 2) residuals, 0 on dead observations."""
    M = prob.obs_point.shape[0]
    out = torch.cat([_residual(*_args(prob, points, ext, intr, sl))
                     for sl in _blocks(M)]) if M else prob.obs_xy * 0
    return out * obs_mask[:, None]


def cost(prob, points, ext, intr, obs_mask) -> torch.Tensor:
    """0.5 sum of squared residuals over the live observations."""
    r = residuals(prob, points, ext, intr, obs_mask)
    return 0.5 * torch.sum(r * r)


def jacobians(prob, points, ext, intr, sl):
    """(r (m, 2), J_point (m, 2, 3), J_cam (m, 2, 18)) of one block; the
    camera columns are [outer row (6), inner row (6), intrinsic (6)]."""
    args = _args(prob, points, ext, intr, sl)
    r = _residual(*args)
    cols = []
    for i, width in enumerate((3, 6, 6, 6)):
        for j in range(width):
            tangent = [torch.zeros_like(a) for a in args[:4]]
            tangent[i][:, j] = 1.0
            _, d = torch.func.jvp(lambda *a: _residual(*a, *args[4:]),
                                  args[:4], tuple(tangent))
            cols.append(d)
    J = torch.stack(cols, dim=2)
    return r, J[:, :, :3], J[:, :, 3:]


def camera_columns(prob, sl) -> torch.Tensor:
    """(m, 18) flat camera columns of a block's observations."""
    six = torch.arange(6, device=prob.ext.device)
    R = prob.ext.shape[0]
    return torch.cat([6 * prob.obs_outer[sl, None] + six,
                      6 * prob.obs_inner[sl, None] + six,
                      6 * R + 6 * prob.obs_intr[sl, None] + six], dim=1)


def camera_vector(ext, intr):
    return torch.cat([ext.reshape(-1), intr.reshape(-1)])


def split_cameras(vec, prob):
    R = prob.ext.shape[0]
    return vec[: 6 * R].reshape(R, 6), vec[6 * R:].reshape(-1, 6)


@dataclasses.dataclass
class Options:
    """Ceres' trust-region defaults and the reference's caps."""

    max_iterations: int = 100
    initial_radius: float = 1e4
    min_radius: float = 1e-32
    max_radius: float = 1e16
    min_relative_decrease: float = 1e-3
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    linear_solver: str = "dense_schur"
    cg_max_iterations: int = 500
    cg_tolerance: float = 1e-10

    @classmethod
    def of(cls, d: dict) -> "Options":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class _System:
    """One linearization: cost, point gradient and Grams, camera gradient
    and Gram diagonal, and what the reduced camera solve needs."""

    def __init__(self, prob, points, ext, intr, obs_mask, pfree, cfree,
                 dense: bool):
        dt, dev = points.dtype, points.device
        N, C = points.shape[0], prob.n_cols
        M = prob.obs_point.shape[0]
        self.cost = torch.zeros((), dtype=dt, device=dev)
        self.g_p = torch.zeros((N, 3), dtype=dt, device=dev)
        self.hpp = torch.zeros((N, 3, 3), dtype=dt, device=dev)
        self.g_c = torch.zeros((C,), dtype=dt, device=dev)
        self.hcc_diag = torch.zeros((C,), dtype=dt, device=dev)
        self.dense = dense
        if dense:
            self.E = torch.zeros((3 * N, C), dtype=dt, device=dev)
            self.hcc = torch.zeros((C, C), dtype=dt, device=dev)
        else:
            self.blocks = []
            self.jacobi = torch.zeros((C // 6, 6, 6), dtype=dt, device=dev)
        for sl in _blocks(M):
            r, jp, jc = jacobians(prob, points, ext, intr, sl)
            live = obs_mask[sl, None, None]
            pt, cols = prob.obs_point[sl], camera_columns(prob, sl)
            jp = jp * live * pfree[pt][:, None, :]
            jc = jc * live * cfree[cols][:, None, :]
            r = r * live[:, :, 0]
            self.cost += 0.5 * torch.sum(r * r)
            self.g_p.index_add_(0, pt, torch.einsum("mki,mk->mi", jp, r))
            self.hpp.index_add_(0, pt, torch.einsum("mki,mkj->mij", jp, jp))
            self.g_c.index_add_(0, cols.reshape(-1),
                                torch.einsum("mki,mk->mi", jc, r).reshape(-1))
            self.hcc_diag.index_add_(0, cols.reshape(-1),
                                     torch.sum(jc * jc, dim=1).reshape(-1))
            if dense:
                w = torch.einsum("mki,mkj->mij", jp, jc)        # (m, 3, 18)
                rows = (3 * pt[:, None, None]
                        + torch.arange(3, device=dev)[None, :, None])
                self.E.index_put_((rows.expand_as(w), cols[:, None, :]
                                   .expand_as(w)), w, accumulate=True)
                jd = torch.zeros((r.shape[0], 2, C), dtype=dt, device=dev)
                jd.scatter_(2, cols[:, None, :].expand_as(jc), jc)
                jd = jd.reshape(-1, C)
                self.hcc += jd.T @ jd
            else:
                self.blocks.append((sl, pt, cols, jp, jc))
                rows6 = cols[:, ::6] // 6                         # (m, 3)
                for g in range(3):
                    b = jc[:, :, 6 * g:6 * g + 6]
                    self.jacobi.index_add_(
                        0, rows6[:, g], torch.einsum("mki,mkj->mij", b, b))

    # --- the products with E = J_point^T J_cam (per point, per camera) ---
    def e_dot(self, v):
        """E v: (N, 3) from a camera vector (C,)."""
        if self.dense:
            return (self.E @ v).reshape(-1, 3)
        out = torch.zeros_like(self.g_p)
        for _, pt, cols, jp, jc in self.blocks:
            t = torch.einsum("mkc,mc->mk", jc, v[cols])
            out.index_add_(0, pt, torch.einsum("mki,mk->mi", jp, t))
        return out

    def e_t_dot(self, w):
        """E^T w: (C,) from a point vector (N, 3)."""
        if self.dense:
            return self.E.T @ w.reshape(-1)
        out = torch.zeros_like(self.g_c)
        for _, pt, cols, jp, jc in self.blocks:
            t = torch.einsum("mki,mi->mk", jp, w[pt])
            out.index_add_(0, cols.reshape(-1),
                           torch.einsum("mkc,mk->mc", jc, t).reshape(-1))
        return out

    def hcc_dot(self, v):
        if self.dense:
            return self.hcc @ v
        out = torch.zeros_like(self.g_c)
        for _, pt, cols, jp, jc in self.blocks:
            t = torch.einsum("mkc,mc->mk", jc, v[cols])
            out.index_add_(0, cols.reshape(-1),
                           torch.einsum("mkc,mk->mc", jc, t).reshape(-1))
        return out


def _lm_diag(d, o: Options):
    return torch.clamp(d, o.min_lm_diagonal, o.max_lm_diagonal)


def _inv3(a):
    return torch.linalg.inv_ex(a).inverse


def pcg(matvec, b, precond, max_iterations, tol):
    """Preconditioned conjugate gradient from x = 0 while
    ||r||^2 > (tol ||b||)^2, at most ``max_iterations`` steps."""
    atol2 = (tol * torch.linalg.norm(b)) ** 2
    x = torch.zeros_like(b)
    r = b
    p = precond(b)
    rz = torch.dot(b, p)
    k = 0
    while k < max_iterations and bool(torch.dot(r, r) > atol2):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        alpha = rz / denom if bool(denom > 0) else torch.zeros_like(rz)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz if bool(rz > 0) else torch.zeros_like(rz)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, k


def _masked_cholesky_solve(S, b, free):
    S = S * (free[:, None] * free[None, :]) + torch.diag(1.0 - free)
    L, info = torch.linalg.cholesky_ex(S)
    if int(info) != 0:
        return torch.full_like(b, float("nan"))
    return torch.cholesky_solve((b * free)[:, None], L)[:, 0] * free


def _step(sys, radius, pfree, cfree, o: Options):
    """(dp, dc, PCG iterations) of the damped Gauss-Newton step."""
    d_p = _lm_diag(torch.diagonal(sys.hpp, dim1=-2, dim2=-1), o)
    eye = torch.eye(3, dtype=sys.hpp.dtype, device=sys.hpp.device)
    binv = _inv3(sys.hpp + eye * (d_p / radius)[:, :, None]
                 + eye * (1.0 - pfree)[:, :, None])
    cam_aug = _lm_diag(sys.hcc_diag, o) / radius
    bg = torch.einsum("pij,pj->pi", binv, sys.g_p)
    rhs = (-sys.g_c + sys.e_t_dot(bg)) * cfree
    cg = 0
    if sys.dense:
        N, C = sys.g_p.shape[0], rhs.shape[0]
        be = torch.einsum("pij,pjc->pic", binv,
                          sys.E.reshape(N, 3, C)).reshape(3 * N, C)
        S = sys.hcc + torch.diag(cam_aug) - sys.E.T @ be
        dc = _masked_cholesky_solve(S, rhs, cfree)
    else:
        def matvec(v):
            vm = v * cfree
            w = torch.einsum("pij,pj->pi", binv, sys.e_dot(vm))
            s = sys.hcc_dot(vm) + cam_aug * v - sys.e_t_dot(w)
            return torch.where(cfree > 0.5, s, v)

        frozen = (1.0 - cfree).reshape(-1, 6)
        blocks = sys.jacobi + torch.eye(6, dtype=rhs.dtype,
                                        device=rhs.device) * (
            cam_aug.reshape(-1, 6) + frozen)[:, :, None]
        inv_blocks = torch.linalg.inv_ex(blocks).inverse
        precond = lambda v: torch.einsum(
            "bij,bj->bi", inv_blocks, v.reshape(-1, 6)).reshape(-1)
        x, cg = pcg(matvec, rhs, precond, o.cg_max_iterations,
                    o.cg_tolerance)
        dc = x * cfree
    dp = -torch.einsum("pij,pj->pi", binv, sys.g_p + sys.e_dot(dc)) * pfree
    return dp, dc, cg


def _model_change(sys, dp, dc):
    """m(0) - m(dx) of the Gauss-Newton model from the stored pieces."""
    e_dc = sys.e_dot(dc)
    dtg = torch.sum(dp * sys.g_p) + torch.dot(dc, sys.g_c)
    dhd = (torch.einsum("pi,pij,pj->", dp, sys.hpp, dp)
           + 2.0 * torch.sum(dp * e_dc) + torch.dot(dc, sys.hcc_dot(dc)))
    return -(dtg + 0.5 * dhd)


@dataclasses.dataclass
class Solved:
    points: torch.Tensor
    ext: torch.Tensor
    intr: torch.Tensor
    cost: float
    iterations: int
    status: int
    cg_iterations: int


def solve(prob: Problem, points, ext, intr, obs_mask, pfree, ext_free,
          intr_free, o: Options) -> Solved:
    """Levenberg-Marquardt to convergence from (points, ext, intr) over the
    free coordinates (masks shaped as the parameters); status 2 function,
    3 gradient, 4 parameter tolerance, 5 radius collapsed, 0 iteration
    cap."""
    dense = o.linear_solver == "dense_schur"
    cfree = camera_vector(ext_free, intr_free)
    cam = camera_vector(ext, intr)
    radius, decrease = o.initial_radius, 2.0
    cur = float(cost(prob, points, ext, intr, obs_mask))
    k, status, cg_total = 0, 0, 0
    while status == 0 and k < o.max_iterations:
        sys = _System(prob, points, *split_cameras(cam, prob), obs_mask,
                      pfree, cfree, dense)
        dp, dc, cg = _step(sys, radius, pfree, cfree, o)
        cg_total += cg
        mcc = float(_model_change(sys, dp, dc))
        new_points, new_cam = points + dp, cam + dc
        new = float(cost(prob, new_points, *split_cameras(new_cam, prob),
                         obs_mask))
        rho = (cur - new) / max(mcc, 1e-300)
        accept = mcc > 0 and rho > o.min_relative_decrease
        grad_max = max(float(torch.max(torch.abs(sys.g_c))),
                       float(torch.max(torch.abs(sys.g_p))))
        step_norm = float(torch.sqrt(torch.sum(dp * dp)
                                     + torch.dot(dc, dc)))
        x_norm = float(torch.sqrt(torch.sum(points * points)
                                  + torch.dot(cam, cam)))
        ftol = accept and abs(cur - new) <= o.function_tolerance * cur
        ptol = accept and step_norm <= o.parameter_tolerance * (
            x_norm + o.parameter_tolerance)
        if accept:
            shrink = max(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
            radius, decrease = min(radius / shrink, o.max_radius), 2.0
            points, cam, cur = new_points, new_cam, new
        else:
            radius, decrease = radius / decrease, decrease * 2.0
        k += 1
        if grad_max <= o.gradient_tolerance:
            status = 3
        elif ftol:
            status = 2
        elif ptol:
            status = 4
        elif radius <= o.min_radius:
            status = 5
        del sys
    e, i = split_cameras(cam, prob)
    return Solved(points, e, i, cur, k, status, cg_total)


# --- masks of the pipeline's solves (``src/sfm.cc:50-63``) ---------------
INTRINSIC_COLUMNS = {"center": (0, 1), "focal": (2, 3), "k1": (4,),
                     "k2": (5,)}


def free_masks(prob, point_alive, freeze_camera: bool,
               free_intrinsics=()):
    """(point, extrinsic, intrinsic) free masks: record 0 is the gauge, the
    identity row stays frozen, and of the intrinsics only the parameters
    that ``free_intrinsics`` names ("center", "focal", "k1", "k2") and that
    each camera's model has (a shared focal length is one, ``dist_size``
    terms of distortion) are free; ``freeze_camera`` holds every camera;
    dead points are frozen."""
    ext_free = torch.ones_like(prob.ext)
    ext_free[0] = 0.0
    ext_free[-1] = 0.0
    intr_free = torch.zeros_like(prob.intr)
    if freeze_camera:
        ext_free.zero_()
    else:
        for name in free_intrinsics:
            intr_free[:, INTRINSIC_COLUMNS[name]] = 1.0
        intr_free[:, 3] *= 1.0 - prob.focal_shared
        intr_free[:, 4] *= prob.m1
        intr_free[:, 5] *= prob.m2
    pfree = torch.ones_like(prob.points) * point_alive[:, None]
    return pfree, ext_free, intr_free


# --- hemisphere prior and filter -----------------------------------------
def camera_centers(data, ext) -> torch.Tensor:
    """Shared rig: one center per (arc, ring) cell in arc-major order (ring
    0 the arc's own camera, arc 0 the ring's, else the composed camera
    ``-R_ring^T (R_arc^T t_arc + t_ring)``); otherwise one per record."""
    rot, t = ext[:-1, :3], ext[:-1, 3:]

    def rt(aa, v):           # R^T v
        return rotate(-aa, v)

    if not data.share_extrinsic:
        return -rt(rot, t)
    A, R = data.arc_size, data.ring_size
    arc = np.repeat(np.arange(A), R)
    ring = np.tile(np.arange(R), A)
    rec = np.where(ring == 0, 0, ring + A - 1)
    ra, ta = rot[arc], t[arc]
    rr, tr = rot[rec], t[rec]
    composed = -rt(rr, rt(ra, ta) + tr)
    single_arc = -rt(ra, ta)
    single_ring = -rt(rr, tr)
    dev = ext.device
    use_arc = torch.as_tensor(ring == 0, device=dev)[:, None]
    use_ring = torch.as_tensor((arc == 0) & (ring != 0), device=dev)[:, None]
    return torch.where(use_arc, single_arc,
                       torch.where(use_ring, single_ring, composed))


def fit_hemisphere(centers, max_iterations: int = 1000) -> torch.Tensor:
    """[cx, cy, cz, r^2] minimising sum (|c - x_i|^2 - r^2)^2 by dense LM
    from center 0, radius 1 (``src/sfm.cc:86-103``)."""
    o = Options(max_iterations=max_iterations)
    f = lambda x: torch.sum((x[None, :3] - centers) ** 2, dim=1) - x[3]
    x = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=centers.dtype,
                     device=centers.device)
    r = f(x)
    cur = float(0.5 * torch.dot(r, r))
    radius, decrease = o.initial_radius, 2.0
    k, status = 0, 0
    while status == 0 and k < o.max_iterations:
        r = f(x)
        J = torch.func.jacfwd(f)(x)
        g = J.T @ r
        jtj = J.T @ J
        A = jtj + torch.diag(_lm_diag(torch.diagonal(jtj), o)) / radius
        L, info = torch.linalg.cholesky_ex(A)
        dx = (torch.cholesky_solve(-g[:, None], L)[:, 0] if int(info) == 0
              else torch.full_like(x, float("nan")))
        jdx = J @ dx
        mcc = float(-(torch.dot(r, jdx) + 0.5 * torch.dot(jdx, jdx)))
        rn = f(x + dx)
        new = float(0.5 * torch.dot(rn, rn))
        rho = (cur - new) / max(mcc, 1e-300)
        accept = mcc > 0 and rho > o.min_relative_decrease
        g_max = float(torch.max(torch.abs(g)))
        ftol = accept and abs(cur - new) <= o.function_tolerance * cur
        ptol = accept and float(torch.linalg.norm(dx)) <= (
            o.parameter_tolerance * (float(torch.linalg.norm(x))
                                     + o.parameter_tolerance))
        if accept:
            shrink = max(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
            radius, decrease = min(radius / shrink, o.max_radius), 2.0
            x, cur = x + dx, new
        else:
            radius, decrease = radius / decrease, decrease * 2.0
        k += 1
        if g_max <= o.gradient_tolerance:
            status = 3
        elif ftol:
            status = 2
        elif ptol:
            status = 4
        elif radius <= o.min_radius:
            status = 5
    return x


def filter_masks(prob, points, ext, intr, obs_mask, point_alive, hemi,
                 boundary: float):
    """``filterPoint3d``: observations whose (r0^2 + r1^2) / 2 exceeds the
    boundary die, points with no live observation die, points farther
    than r^2 / 2 in squared distance from the hemisphere's center die with
    their observations."""
    r = residuals(prob, points, ext, intr, obs_mask)
    mse = 0.5 * torch.sum(r * r, dim=1)
    obs_mask = obs_mask * (mse <= boundary).to(obs_mask.dtype)
    live = torch.zeros_like(point_alive).index_add_(0, prob.obs_point,
                                                    obs_mask)
    point_alive = point_alive * (live > 0).to(point_alive.dtype)
    d2 = torch.sum((points - hemi[None, :3]) ** 2, dim=1)
    point_alive = point_alive * (d2 <= hemi[3] / 2.0).to(point_alive.dtype)
    return obs_mask * point_alive[prob.obs_point], point_alive


def pipeline(data, o: Options, boundary: float, hemisphere_iterations: int,
             max_rounds: int, dtype, device) -> dict:
    """The solve/filter loop of ``src/sfm.cc:77-131``: hemisphere fit on
    the starting cameras, a points-only solve, the filter, then rounds of
    full solve and filter until the point count stops changing."""
    prob = problem(data, dtype, device)
    hemi = fit_hemisphere(camera_centers(data, prob.ext),
                          hemisphere_iterations)
    obs_mask = torch.ones(prob.obs_point.shape[0], dtype=dtype,
                          device=device)
    alive = torch.ones(prob.points.shape[0], dtype=dtype, device=device)
    points, ext, intr = prob.points, prob.ext, prob.intr
    res = solve(prob, points, ext, intr, obs_mask,
                *free_masks(prob, alive, True), o)
    points, ext, intr = res.points, res.ext, res.intr
    obs_mask, alive = filter_masks(prob, points, ext, intr, obs_mask, alive,
                                   hemi, boundary)
    rounds, old, current = 0, -1, int(alive.sum())
    while current != old and rounds < max_rounds:
        rounds += 1
        old = current
        res = solve(prob, points, ext, intr, obs_mask,
                    *free_masks(prob, alive, False), o)
        points, ext, intr = res.points, res.ext, res.intr
        obs_mask, alive = filter_masks(prob, points, ext, intr, obs_mask,
                                       alive, hemi, boundary)
        current = int(alive.sum())
    final = float(cost(prob, points, ext, intr, obs_mask))
    n_live = max(float(obs_mask.sum()), 1.0)
    return dict(hemisphere=hemi, obs_alive=obs_mask > 0.5,
                point_alive=alive > 0.5, points=points, ext=ext, intr=intr,
                rounds=rounds, final_cost=final,
                final_rmse=float(np.sqrt(2.0 * final / n_live)))

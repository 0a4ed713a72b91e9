"""The plain reference of BFS incremental bundle adjustment of independent
cameras with pose-graph refinement, written from its description on
``reference.py``'s problem, masks and solver; it imports nothing of the
program.

  * the covisibility of two cameras is the number of points both see;
  * the order is a breadth-first search over that graph from ``start``
    (``incremental.bfs_order``: strongest neighbour first, ties by the
    lower index, unreached cameras in index order);
  * batch b registers ``order[b * size:(b + 1) * size]``; an observation
    is active when its camera is, a point live when ``min_observations``
    of its observations are active;
  * when a pair of registered cameras (i < j) first shares at least
    ``min_covis`` points, the relative pose of their current estimates,
    T_ij = T_i o T_j^-1, is kept as that edge's measurement;
  * each batch runs a structure-only solve (every camera frozen, the live
    points free), then a pose graph over the registered poses (camera 0
    and the unregistered cameras anchored), then the full solve (the
    registered cameras but camera 0 free, intrinsics held, the live
    points free), each from the previous one's answer, over the active
    observations;
  * the pose graph's residual of an edge is the 6-dof log of the
    discrepancy, R_rel = R_i R_j^T, t_rel = t_i - R_rel t_j,
    r = [log(R_meas^T R_rel), t_rel - t_meas]; it is minimised by
    Levenberg-Marquardt with Ceres' trust-region law on normal equations
    of the free poses, gathered from each edge's 6 x 12 Jacobian (forward
    mode, one tangent a column) in 6 x 6 blocks and solved by Cholesky.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import reference as ref
from portbench.incremental import bfs_order

POINT_CHUNK = 1 << 17      # points a block of the covisibility product


def cameras_of(data) -> np.ndarray:
    """Each observation's camera: its (outer) extrinsic record."""
    return ref.wiring(data)[0]


def covisibility(data, device="cpu") -> np.ndarray:
    """(C, C) counts of the points each two cameras both see, the
    diagonal zero: float64 products over blocks of points (exact below
    2**53)."""
    C = data.n_extrinsics
    point = torch.as_tensor(data.obs_point.astype(np.int64), device=device)
    cam = torch.as_tensor(cameras_of(data), device=device)
    counts = torch.zeros((C, C), dtype=torch.float64, device=device)
    for p0 in range(0, data.n_points, POINT_CHUNK):
        sel = (point >= p0) & (point < p0 + POINT_CHUNK)
        seen = torch.zeros((min(POINT_CHUNK, data.n_points - p0), C),
                           dtype=torch.float64, device=device)
        seen[point[sel] - p0, cam[sel]] = 1.0
        counts += seen.T @ seen
    out = counts.cpu().numpy().astype(np.int64)
    np.fill_diagonal(out, 0)
    return out


# --- rotations ------------------------------------------------------------
def to_matrix(aa):
    """Angle-axis (..., 3) -> rotation matrix (..., 3, 3): its columns
    are the rotated unit vectors."""
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    cols = [ref.rotate(aa, eye[k].expand(aa.shape)) for k in range(3)]
    return torch.stack(cols, dim=-1)


def to_angle_axis(R):
    """Rotation matrix (..., 3, 3) -> angle-axis (..., 3) through the unit
    quaternion: Shepperd's choice of the largest of (trace, R00, R11, R22)
    for the quaternion, then 2 atan2(|v|, w) v / |v| (2 v / w near angle
    0), w >= 0."""
    m = lambda a, b: R[..., a, b]
    tr = m(0, 0) + m(1, 1) + m(2, 2)
    cands = []
    for s, q in (
            (1.0 + tr, (None, m(2, 1) - m(1, 2), m(0, 2) - m(2, 0),
                        m(1, 0) - m(0, 1))),
            (1.0 + m(0, 0) - m(1, 1) - m(2, 2),
             (m(2, 1) - m(1, 2), None, m(0, 1) + m(1, 0),
              m(0, 2) + m(2, 0))),
            (1.0 - m(0, 0) + m(1, 1) - m(2, 2),
             (m(0, 2) - m(2, 0), m(0, 1) + m(1, 0), None,
              m(1, 2) + m(2, 1))),
            (1.0 - m(0, 0) - m(1, 1) + m(2, 2),
             (m(1, 0) - m(0, 1), m(0, 2) + m(2, 0), m(1, 2) + m(2, 1),
              None))):
        s = torch.clamp(s, min=1e-30)
        root = torch.sqrt(s)
        parts = [root / 2.0 if c is None else c / (2.0 * root) for c in q]
        cands.append(torch.stack(parts, dim=-1))
    key = torch.stack([tr, m(0, 0), m(1, 1), m(2, 2)], dim=-1)
    best = torch.argmax(key, dim=-1)
    q = cands[0]
    for k in (1, 2, 3):
        q = torch.where((best == k)[..., None], cands[k], q)
    q = torch.where((q[..., :1] < 0), -q, q)
    w, v = q[..., 0], q[..., 1:]
    s2 = torch.sum(v * v, dim=-1)
    small = s2 < 1e-24
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    scale = torch.where(small, 2.0 / w, 2.0 * torch.atan2(s, w) / s)
    return v * scale[..., None]


def relative(pose_i, pose_j):
    """(R_rel, t_rel) of T_i o T_j^-1 for poses (..., 6) [aa, t]."""
    R_i, R_j = to_matrix(pose_i[..., :3]), to_matrix(pose_j[..., :3])
    R_rel = R_i @ R_j.transpose(-1, -2)
    t_rel = pose_i[..., 3:] - (R_rel @ pose_j[..., 3:, None])[..., 0]
    return R_rel, t_rel


def edge_residual(pose_i, pose_j, R_meas, t_meas):
    """(L, 6) residuals [log(R_meas^T R_rel), t_rel - t_meas]."""
    R_rel, t_rel = relative(pose_i, pose_j)
    rot = to_angle_axis(R_meas.transpose(-1, -2) @ R_rel)
    return torch.cat([rot, t_rel - t_meas], dim=-1)


def edge_jacobian(pose_i, pose_j, R_meas, t_meas):
    """(r (L, 6), J (L, 6, 12)): the Jacobian by [pose_i, pose_j], one
    forward-mode tangent a column."""
    r = edge_residual(pose_i, pose_j, R_meas, t_meas)
    cols = []
    for k in range(12):
        ti, tj = torch.zeros_like(pose_i), torch.zeros_like(pose_j)
        (ti if k < 6 else tj)[:, k % 6] = 1.0
        _, d = torch.func.jvp(
            lambda a, b: edge_residual(a, b, R_meas, t_meas),
            (pose_i, pose_j), (ti, tj))
        cols.append(d)
    return r, torch.stack(cols, dim=2)


def pose_graph(poses, edges, R_meas, t_meas, anchor, o: ref.Options):
    """Levenberg-Marquardt over the (C, 6) poses from ``poses``, the
    ``anchor`` rows held; at most ``o.max_iterations`` steps. Returns the
    refined poses and the iterations."""
    dt, dev = poses.dtype, poses.device
    C = poses.shape[0]
    free = torch.nonzero(~anchor)[:, 0]
    F = free.numel()
    fid = torch.full((C,), F, dtype=torch.long, device=dev)
    fid[free] = torch.arange(F, device=dev)
    i, j = edges[:, 0], edges[:, 1]
    fi, fj = fid[i], fid[j]

    def cost_of(x):
        r = edge_residual(x[i], x[j], R_meas, t_meas)
        return float(0.5 * torch.sum(r * r))

    x = poses
    cur = cost_of(x)
    radius, decrease = o.initial_radius, 2.0
    k, status = 0, 0
    while status == 0 and k < o.max_iterations:
        r, J = edge_jacobian(x[i], x[j], R_meas, t_meas)
        Ji, Jj = J[:, :, :6], J[:, :, 6:]
        blocks = torch.zeros((F + 1, F + 1, 6, 6), dtype=dt, device=dev)
        for a, b, Ja, Jb in ((fi, fi, Ji, Ji), (fj, fj, Jj, Jj),
                             (fi, fj, Ji, Jj), (fj, fi, Jj, Ji)):
            blocks.index_put_((a, b), torch.einsum("lki,lkj->lij", Ja, Jb),
                              accumulate=True)
        H = blocks[:F, :F].permute(0, 2, 1, 3).reshape(6 * F, 6 * F)
        g = torch.zeros((F + 1, 6), dtype=dt, device=dev)
        g.index_add_(0, fi, torch.einsum("lki,lk->li", Ji, r))
        g.index_add_(0, fj, torch.einsum("lki,lk->li", Jj, r))
        g = g[:F].reshape(-1)
        d = torch.clamp(torch.diagonal(H), o.min_lm_diagonal,
                        o.max_lm_diagonal)
        L, info = torch.linalg.cholesky_ex(H + torch.diag(d) / radius)
        sol = (torch.cholesky_solve(-g[:, None], L)[:, 0] if int(info) == 0
               else torch.full_like(g, float("nan")))
        dx = torch.zeros_like(x)
        dx[free] = sol.reshape(-1, 6)
        j_dx = (torch.einsum("lki,li->lk", Ji, dx[i])
                + torch.einsum("lki,li->lk", Jj, dx[j]))
        mcc = float(-(torch.sum(r * j_dx) + 0.5 * torch.sum(j_dx * j_dx)))
        new = cost_of(x + dx)
        rho = (cur - new) / max(mcc, 1e-300)
        accept = mcc > 0 and rho > o.min_relative_decrease
        grad_max = float(torch.max(torch.abs(g))) if F else 0.0
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
        if grad_max <= o.gradient_tolerance:
            status = 3
        elif ftol:
            status = 2
        elif ptol:
            status = 4
        elif radius <= o.min_radius:
            status = 5
    return x, k


def _active_problem(prob: ref.Problem, keep) -> ref.Problem:
    """The problem over the observations ``keep`` selects (the inactive
    ones add nothing to any sum)."""
    return dataclasses.replace(
        prob, obs_point=prob.obs_point[keep], obs_outer=prob.obs_outer[keep],
        obs_inner=prob.obs_inner[keep], obs_intr=prob.obs_intr[keep],
        obs_xy=prob.obs_xy[keep])


def run(data, o: ref.Options, batch_size: int, dtype, device,
        start: int = 0, min_observations: int = 2, min_covis: int = 3,
        pose_graph_iterations: int = 20) -> dict:
    """The whole incremental reconstruction: the final points, cameras and
    cost, the order, the edges (L, 3) as (i, j, batch captured) in
    capture order (by batch, then (i, j)), and per batch the registered
    cameras, live points, edges, both solves' iterations and the full
    solve's cost."""
    prob = ref.problem(data, dtype, device)
    C = data.n_extrinsics
    counts = covisibility(data, device)
    order = bfs_order(counts, start)
    strong = np.triu(counts >= min_covis, 1)
    cam = torch.as_tensor(cameras_of(data), device=device)
    registered = np.zeros(C, bool)
    points, ext, intr = prob.points, prob.ext, prob.intr
    edges = np.zeros((0, 3), np.int64)
    meas_R = torch.zeros((0, 3, 3), dtype=dtype, device=device)
    meas_t = torch.zeros((0, 3), dtype=dtype, device=device)
    pg_options = ref.Options(max_iterations=pose_graph_iterations)
    history = []
    for b in range(-(-C // batch_size)):
        before = registered.copy()
        registered[order[b * batch_size:(b + 1) * batch_size]] = True
        new = (strong & np.outer(registered, registered)
               & ~np.outer(before, before))
        ii, jj = np.nonzero(new)
        e = torch.as_tensor(np.stack([ii, jj], 1), device=device)
        R_rel, t_rel = relative(ext[e[:, 0]], ext[e[:, 1]])
        edges = np.concatenate([edges, np.stack(
            [ii, jj, np.full_like(ii, b)], 1).astype(np.int64)])
        meas_R = torch.cat([meas_R, R_rel])
        meas_t = torch.cat([meas_t, t_rel])

        reg = torch.as_tensor(registered, device=device)
        keep = reg[cam]
        sub = _active_problem(prob, keep)
        obs = torch.ones(sub.obs_point.shape[0], dtype=dtype, device=device)
        live = (torch.bincount(sub.obs_point, minlength=points.shape[0])
                >= min_observations).to(dtype)
        structure = ref.solve(sub, points, ext, intr, obs,
                              *ref.free_masks(sub, live, True), o)
        points, ext, intr = structure.points, structure.ext, structure.intr
        pg_iterations = 0
        if edges.shape[0]:
            anchor = ~reg
            anchor[0] = True
            ed = torch.as_tensor(edges[:, :2], device=device)
            poses, pg_iterations = pose_graph(ext[:C], ed, meas_R, meas_t,
                                              anchor, pg_options)
            ext = torch.cat([poses, ext[C:]])
        pfree, ext_free, intr_free = ref.free_masks(sub, live, False)
        ext_free[:C] *= reg[:, None].to(dtype)
        full = ref.solve(sub, points, ext, intr, obs, pfree, ext_free,
                         intr_free, o)
        points, ext, intr = full.points, full.ext, full.intr
        history.append({"active_cameras": int(registered.sum()),
                        "live_points": int(live.sum()),
                        "edges": int(edges.shape[0]),
                        "structure_iterations": structure.iterations,
                        "pose_graph_iterations": pg_iterations,
                        "iterations": full.iterations,
                        "cost": full.cost})
    return {"points": points, "ext": ext, "intr": intr,
            "cost": history[-1]["cost"], "order": order, "edges": edges,
            "history": history}

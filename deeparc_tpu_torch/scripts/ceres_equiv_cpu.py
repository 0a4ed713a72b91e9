"""The CPU DENSE_SCHUR timing anchor: one Ceres-equivalent LM iteration on
the host's CPU (numpy and scipy, no device).

    python -m deeparc_tpu_torch.scripts.ceres_equiv_cpu [--n-points 400000]
        [--procs 1,2] [--reps 3]         # minutes at the full size
    python -m deeparc_tpu_torch.scripts.ceres_equiv_cpu --n-points 2000 \\
        --n-arc 4 --n-ring 8 --reps 1    # small

The reference solves with ``ceres::DENSE_SCHUR`` on 16 CPU threads
(``src/sfm.cc:66-73``). Its datasets are stripped, so this measures a
faithful CPU re-implementation of one LM iteration's work on the same
synthetic rig the benchmark uses (``make_hemisphere_rig``, the port's
copy, turned into numpy through the port's ``from_deeparc`` on the CPU),
with the structure Ceres executes:

  1. closed-form residuals + per-observation Jacobian blocks (the work
     Ceres' autodiff Jets do), vectorized single-thread numpy;
  2. per-point 3x3 Hessian blocks + gradients (sorted ``np.add.reduceat``);
  3. the camera system via scipy SPARSE matmuls (C++ kernels):
     Hcc = Jc^T Jc,  E = Jp^T Jc,  S = Hcc - E^T B^-1 E  with block-diagonal
     B^-1 as a sparse operator;
  4. dense Cholesky of S (scipy cho_factor) + back-substitution;
  5. a trial-cost re-evaluation.

The arithmetic below is the reference's ``scripts/ceres_equiv_cpu.py``
as it is. Workers are forked (``multiprocessing``'s fork context; the
problem is inherited copy-on-write), so a process that has touched CUDA
refuses to fork them. Prints one JSON line: {"iters_per_sec": ...,
"detail": {...}} with the host CPU's model and count, whose number it is.
Single threaded; Ceres with 16 threads parallelizes steps 1-3, so the line
also reports a 16-thread figure extrapolated from the measured parallel
efficiency.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import scipy.linalg
import scipy.sparse


def linearize_numpy(pts, Ri, Ro, Roi, ti, to, Jro, Jri, fx, fy, cx, cy,
                    d0, d1, m1, m2, xy):
    """Closed-form residual + Jacobian blocks, flat (M,) numpy.

    Same math as solver/tiles._linearize_chunk (itself the closed form of
    src/snavely_reprojection_error.hh:38-118).
    """
    p2 = np.einsum("mij,mj->mi", Ri, pts) + ti
    p3 = np.einsum("mij,mj->mi", Ro, p2) + to
    inv_z = 1.0 / p3[:, 2]
    u = p3[:, :2] * inv_z[:, None]
    r2 = np.sum(u * u, axis=1)
    dcoef = 1.0 + r2 * (d0 + d1 * r2)
    f2 = np.stack([fx, fy], axis=1)
    pred = f2 * dcoef[:, None] * u + np.stack([cx, cy], axis=1)
    r = pred - xy

    zero = np.zeros_like(inv_z)
    du_dp = np.stack(
        [np.stack([inv_z, zero, -u[:, 0] * inv_z], axis=1),
         np.stack([zero, inv_z, -u[:, 1] * inv_z], axis=1)], axis=1)
    ddcoef = d0 + 2.0 * d1 * r2
    dr2_dp = 2.0 * np.einsum("mk,mka->ma", u, du_dp)
    dres_dp = f2[:, :, None] * (
        dcoef[:, None, None] * du_dp
        + u[:, :, None] * (ddcoef[:, None] * dr2_dp)[:, None, :])

    j_x = np.einsum("mka,mab->mkb", dres_dp, Roi)
    j_to = dres_dp

    def crossm(v):
        out = np.zeros(v.shape[:-1] + (3, 3))
        out[..., 0, 1] = -v[..., 2]
        out[..., 0, 2] = v[..., 1]
        out[..., 1, 0] = v[..., 2]
        out[..., 1, 2] = -v[..., 0]
        out[..., 2, 0] = -v[..., 1]
        out[..., 2, 1] = v[..., 0]
        return out

    j_wo = np.einsum(
        "mka,mab->mkb", dres_dp,
        -np.einsum("mij,mjk,mkl->mil", Ro, crossm(p2), Jro))
    j_ti = np.einsum("mka,mab->mkb", dres_dp, Ro)
    j_wi = np.einsum(
        "mka,mab->mkb", dres_dp,
        -np.einsum("mij,mjk,mkl->mil", Roi, crossm(pts), Jri))
    j_cam = np.concatenate([j_wo, j_to, j_wi, j_ti], axis=2)  # (M, 2, 12)
    return r, j_x, j_cam


# ---------------------------------------------------------------------------
# Shardable per-iteration work (the distributed-Schur structure Ceres'
# 16-thread evaluation parallelizes internally): each worker owns a
# contiguous point range and its observations; only (C, C) camera-system
# partials and the (C,) step cross process boundaries.
# ---------------------------------------------------------------------------

_G: dict = {}   # problem data, fork-inherited (copy-on-write, zero IPC)


def _precompute_obs(o0, o1):
    g = _G
    sl = slice(o0, o1)
    inner, outer, intr = g["inner"][sl], g["outer"][sl], g["intr"][sl]
    from scipy.spatial.transform import Rotation

    R_all = Rotation.from_rotvec(g["ext_rot"]).as_matrix()
    Jr_all = _right_jacobian(g["ext_rot"])
    Ri, Ro = R_all[inner], R_all[outer]
    fsh, dm1, dm2 = g["fsh"][intr], g["dm1"][intr], g["dm2"][intr]
    focal, dist, center = g["focal"], g["dist"], g["center"]
    return dict(
        Ri=Ri, Ro=Ro, Roi=np.einsum("mij,mjk->mik", Ro, Ri),
        ti=g["ext_trans"][inner], to=g["ext_trans"][outer],
        Jro=Jr_all[outer], Jri=Jr_all[inner],
        fx=focal[intr, 0],
        fy=np.where(fsh > 0.5, focal[intr, 0], focal[intr, 1]),
        d0=dist[intr, 0] * dm1, d1=dist[intr, 1] * dm2,
        cx=center[intr, 0], cy=center[intr, 1], m1=dm1, m2=dm2,
        xy=g["xy"][sl], obs_point=g["obs_point"][sl],
        inner=inner, outer=outer,
    )


def _right_jacobian(aa):
    th = np.linalg.norm(aa, axis=-1, keepdims=True)
    th = np.maximum(th, 1e-12)
    k = aa / th
    K = np.zeros(aa.shape[:-1] + (3, 3))
    K[..., 0, 1] = -k[..., 2]
    K[..., 0, 2] = k[..., 1]
    K[..., 1, 0] = k[..., 2]
    K[..., 1, 2] = -k[..., 0]
    K[..., 2, 0] = -k[..., 1]
    K[..., 2, 1] = k[..., 0]
    t = th[..., None]
    A = (1 - np.cos(t)) / t
    B = (t - np.sin(t)) / t
    return np.eye(3) - A * K + B * (K @ K)


def _phase1(p0, p1, o0, o1):
    """Shard linearize + local point elimination. Returns
    (S_partial, rhs_partial, stash-for-phase-2)."""
    g = _G
    C = g["C"]
    ob = _precompute_obs(o0, o1)
    pts_local = g["points"][p0:p1]
    obs_point = ob["obs_point"]
    Mloc = obs_point.size
    Nloc = p1 - p0
    r, j_x, j_cam = linearize_numpy(
        g["points"][obs_point], ob["Ri"], ob["Ro"], ob["Roi"], ob["ti"],
        ob["to"], ob["Jro"], ob["Jri"], ob["fx"], ob["fy"], ob["cx"],
        ob["cy"], ob["d0"], ob["d1"], ob["m1"], ob["m2"], ob["xy"])

    seg = np.searchsorted(obs_point, np.arange(p0, p1))
    gp_obs = np.einsum("mki,mk->mi", j_x, r)
    hpp_obs = np.einsum("mki,mkj->mij", j_x, j_x)
    g_p = np.add.reduceat(gp_obs, seg, axis=0)
    hpp = np.add.reduceat(hpp_obs.reshape(Mloc, 9), seg,
                          axis=0).reshape(Nloc, 3, 3)
    binv = np.linalg.inv(hpp + 1e-4 * np.eye(3))

    cols_o = (ob["outer"][:, None] * 6 + np.arange(6)).astype(np.int64)
    cols_i = (ob["inner"][:, None] * 6 + np.arange(6)).astype(np.int64)
    cols = np.concatenate(
        [np.broadcast_to(cols_o[:, None, :], (Mloc, 2, 6)),
         np.broadcast_to(cols_i[:, None, :], (Mloc, 2, 6))], axis=2).ravel()
    Jc = scipy.sparse.csr_matrix(
        (j_cam.ravel(), (np.repeat(np.arange(2 * Mloc), 12), cols)),
        shape=(2 * Mloc, C))
    prow = np.repeat(np.arange(2 * Mloc), 3)
    pcol = ((obs_point[:, None, None] - p0) * 3
            + np.arange(3)[None, None, :]).repeat(2, axis=1).ravel()
    Jp = scipy.sparse.csr_matrix(
        (j_x.ravel(), (prow, pcol)), shape=(2 * Mloc, 3 * Nloc))

    hcc = (Jc.T @ Jc).toarray()
    E = (Jp.T @ Jc).toarray().reshape(Nloc, 3, C)
    w = np.einsum("pij,pj->pi", binv, g_p)
    g_c = Jc.T @ r.ravel()
    rhs = -g_c + np.einsum("pic,pi->c", E, w)
    BE = np.einsum("pij,pjc->pic", binv, E)
    S = hcc - E.reshape(3 * Nloc, C).T @ BE.reshape(3 * Nloc, C)
    stash = dict(binv=binv, g_p=g_p, E=E, ob=ob, p0=p0, p1=p1)
    return S, rhs, stash


def _phase2(stash, dc):
    """Back-substitute the point step and re-evaluate the shard's trial
    cost."""
    g = _G
    ob = stash["ob"]
    p0, p1 = stash["p0"], stash["p1"]
    e_dc = np.einsum("pic,c->pi", stash["E"], dc)
    dp = -np.einsum("pij,pj->pi", stash["binv"], stash["g_p"] + e_dc)
    trial = g["points"][p0:p1] + dp
    obs_point = ob["obs_point"] - p0
    p2 = np.einsum("mij,mj->mi", ob["Ri"], trial[obs_point]) + ob["ti"]
    p3 = np.einsum("mij,mj->mi", ob["Ro"], p2) + ob["to"]
    u = p3[:, :2] / p3[:, 2:3]
    r2v = np.sum(u * u, axis=1)
    dc2 = 1.0 + r2v * (ob["d0"] + ob["d1"] * r2v)
    pred = (np.stack([ob["fx"], ob["fy"]], 1) * dc2[:, None] * u
            + np.stack([ob["cx"], ob["cy"]], 1))
    return 0.5 * np.sum((pred - ob["xy"]) ** 2)


def _reduce_and_solve(S_parts, rhs_parts):
    g = _G
    C, R_rows = g["C"], g["R_rows"]
    S = sum(S_parts) + 1e-4 * np.eye(C)
    rhs = sum(rhs_parts)
    frozen = np.zeros(C, bool)
    frozen[:6] = True
    frozen[6 * (R_rows - 1):] = True
    S[frozen] = 0.0
    S[:, frozen] = 0.0
    S[frozen, frozen] = 1.0
    rhs[frozen] = 0.0
    return scipy.linalg.cho_solve(scipy.linalg.cho_factor(S), rhs)


def _worker_loop(conn, p0, p1, o0, o1):
    stash = None
    while True:
        msg = conn.recv()
        if msg[0] == "lin":
            S, rhs, stash = _phase1(p0, p1, o0, o1)
            conn.send((S, rhs))
        elif msg[0] == "trial":
            conn.send(_phase2(stash, msg[1]))
        else:
            conn.close()
            return


def _run_iterations(procs, reps):
    """Time ``reps`` LM iterations with ``procs`` workers (procs=1 runs
    inline — identical code path, no IPC)."""
    g = _G
    N = g["points"].shape[0]
    obs_point = g["obs_point"]
    M = obs_point.size

    # shard at point boundaries with ~equal observation counts
    bounds_o = (np.arange(procs + 1) * M) // procs
    bounds_p = np.concatenate(
        [[0], np.minimum(obs_point[np.minimum(bounds_o[1:-1], M - 1)], N),
         [N]]).astype(np.int64)
    bounds_o = np.searchsorted(obs_point, bounds_p)
    shards = [(int(bounds_p[i]), int(bounds_p[i + 1]),
               int(bounds_o[i]), int(bounds_o[i + 1]))
              for i in range(procs)]

    if procs == 1:
        def one():
            S, rhs, stash = _phase1(*shards[0])
            dc = _reduce_and_solve([S], [rhs])
            return _phase2(stash, dc)
    else:
        import multiprocessing as mp

        ctx = mp.get_context("fork")
        conns, workers = [], []
        for sh in shards:
            pc, cc = ctx.Pipe()
            w = ctx.Process(target=_worker_loop, args=(cc,) + sh,
                            daemon=True)
            w.start()
            conns.append(pc)
            workers.append(w)

        def one():
            for c in conns:
                c.send(("lin",))
            parts = [c.recv() for c in conns]
            dc = _reduce_and_solve([p[0] for p in parts],
                                   [p[1] for p in parts])
            for c in conns:
                c.send(("trial", dc))
            return sum(c.recv() for c in conns)

    one()   # warm caches / worker imports
    t0 = time.time()
    for _ in range(reps):
        cost = one()
    dt = (time.time() - t0) / reps
    if procs > 1:
        for c in conns:
            c.send(("stop",))
        for w in workers:
            w.join(timeout=10)
    return dt, float(cost)



def _known(name: str) -> str:
    return "" if name.strip().lower() in ("", "unknown") else name.strip()


def host_cpu() -> dict:
    """The host CPU's model name (``/proc/cpuinfo``'s, else ``lscpu``'s,
    else its vendor, family and model numbers, else the machine type) and
    its logical CPUs (all, and those this process may run on)."""
    import platform
    import subprocess

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                if not key.strip():
                    break
                info.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    model = _known(info.get("model name", ""))
    if not model:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            model = next((_known(line.split(":", 1)[1])
                          for line in out.splitlines()
                          if line.startswith("Model name")), "")
        except (OSError, subprocess.SubprocessError):
            pass
    if not model and _known(info.get("vendor_id", "")):
        model = (f"{info['vendor_id']} family {info.get('cpu family', '?')} "
                 f"model {info.get('model', '?')}")
    model = model or platform.machine() or "unknown"
    usable = (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
              else os.cpu_count())
    return {"host_cpu_model": model, "host_cpu_arch": platform.machine(),
            "host_cpus": os.cpu_count(), "host_cpus_usable": usable}


def load_problem(n_points, n_arc=8, n_ring=24, visibility=10.0 / 192,
                 seed=0) -> float:
    """Fill the workers' problem data ``_G`` from the benchmark rig, built
    by the port on the CPU in float64; returns the seconds it took."""
    import torch

    from deeparc_tpu_torch.io import make_hemisphere_rig
    from deeparc_tpu_torch.scene import from_deeparc

    t0 = time.time()
    rig = make_hemisphere_rig(
        n_arc=n_arc, n_ring=n_ring, n_points=n_points,
        visibility=visibility, pixel_noise=1.0, point_noise=0.02, seed=seed,
    )
    scene = from_deeparc(rig.data, dtype=torch.float64, device="cpu")
    idx, p = scene.index, scene.params
    R_rows = int(p.ext_rot.shape[0])
    W = lambda t: t.detach().numpy().copy()   # scipy cython needs writable
    _G.clear()
    _G.update(
        obs_point=W(idx.obs_point),
        outer=W(idx.obs_outer), inner=W(idx.obs_inner),
        intr=W(idx.obs_intr), xy=W(idx.obs_xy),
        ext_rot=W(p.ext_rot), ext_trans=W(p.ext_trans), center=W(p.center),
        focal=W(p.focal), dist=W(p.dist), points=W(p.points),
        fsh=W(idx.focal_shared), dm1=W(idx.dist_m1), dm2=W(idx.dist_m2),
        C=6 * R_rows, R_rows=R_rows,
    )
    return time.time() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-points", type=int, default=400_000)
    ap.add_argument("--n-arc", type=int, default=8)
    ap.add_argument("--n-ring", type=int, default=24)
    ap.add_argument("--visibility", type=float, default=10.0 / 192)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--procs", type=str, default="1,2",
                    help="comma list of worker counts to measure "
                         "(distributed-Schur process parallelism)")
    args = ap.parse_args(argv)
    proc_list = [int(x) for x in args.procs.split(",") if x]
    if max(proc_list) > 1 and "torch" in sys.modules:
        import torch

        if torch.cuda.is_initialized():
            raise RuntimeError("CUDA is initialised in this process: its "
                               "workers must not fork it")

    gen_s = load_problem(args.n_points, args.n_arc, args.n_ring,
                         args.visibility, args.seed)
    M = _G["obs_point"].size
    curve = {}
    cost0 = None
    for p in proc_list:
        dt, cost = _run_iterations(p, args.reps)
        curve[p] = 1.0 / dt
        if cost0 is None:
            cost0 = cost
        else:
            # summation-order noise amplified through the ill-conditioned
            # Schur solve; the tolerance covers the dc perturbation only
            assert abs(cost - cost0) / max(cost0, 1e-12) < 1e-4, (
                "sharded trial cost must match single-process", cost, cost0)
    ips1 = curve[min(curve)]
    pmax = max(curve)
    eff = (curve[pmax] / (pmax * ips1)) if pmax > 1 else 1.0
    est16 = ips1 * 16 * eff
    host = host_cpu()

    print(json.dumps({
        "iters_per_sec": ips1,
        "platform": "cpu", "device": host["host_cpu_model"],
        "detail": {
            "seconds_per_iter": 1.0 / ips1, "n_obs": int(M),
            "n_points": int(_G["points"].shape[0]),
            "gen_s": round(gen_s, 1), "reps": args.reps, **host,
            "iters_per_sec_by_procs": {str(k): round(v, 4)
                                       for k, v in sorted(curve.items())},
            "parallel_efficiency": round(eff, 4),
            "iters_per_sec_16t_est": round(est16, 4),
            "est16_note": (
                "16-thread figure EXTRAPOLATED as ips(1) * 16 * measured "
                f"parallel efficiency at {pmax} procs (the host has "
                f"{host['host_cpus_usable']} usable CPUs; a real 16-core "
                "Ceres run is not measured here)"),
            "method": "numpy closed-form jacobians + scipy sparse "
                      "JtJ/E + dense Cholesky (DENSE_SCHUR structure), "
                      "distributed-Schur process sharding",
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark's inputs, made from ``--seed``: the contents of a
``.deeparc`` file, drawn on the card with a ``torch.Generator`` of their
own and moved to the host.

One general generator reads a configuration (the scene's sizes, geometry
and noise) and a traffic mix (its visibility law), both plain data files.
Two visibility laws exist:

  ``rig``  the shared-extrinsic turntable rig of ``src/sfm.cc``: cameras
           on a meridian arc (arcs) around an object on a turntable (rings),
           composed extrinsics ``p = R_arc (R_ring X + t_ring) + t_arc``;
           each (point, cell) pair is seen when it lies in the image and,
           with ``occlusion_rings``, while the turntable turns the point
           toward the cameras (a cyclic window of that many ring steps),
           then kept with probability ``visibility``;
  ``bal``  independent cameras (BAL's 9 parameters: angle-axis,
           translation, focal, k1, k2) on a view sphere ordered by azimuth;
           each point's track length drawn from a clipped log-normal and
           adjusted to the configuration's exact observation count, its
           cameras distinct and drawn from a window of consecutive cameras;
           the observations are projected through the true cameras, and
           the starting cameras carry the configuration's camera noise.

The arithmetic is a frozen copy of the program's sound generators
(``io/synthetic.py`` ``make_hemisphere_rig``, ``make_bal_heavytail_device``)
and of the Snavely projection; nothing of the program is imported, and the
program and the reference are handed the same arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DeepArcArrays:
    """A ``.deeparc`` file's contents, by the field names the program's
    ``from_deeparc`` and ``run_pipeline`` read."""

    version: float
    share_extrinsic: bool
    arc_size: int            # header n_arc (non-shared: number of cameras)
    ring_size: int           # header n_ring (0: non-shared)
    obs_arc: np.ndarray      # int32 (M,): arc, or intrinsic id
    obs_ring: np.ndarray     # int32 (M,): ring, or extrinsic id
    obs_point: np.ndarray    # int32 (M,)
    obs_xy: np.ndarray       # float64 (M, 2)
    center: np.ndarray       # (K, 2)
    focal: np.ndarray        # (K, 2), zero-padded
    focal_size: np.ndarray   # int32 (K,)
    dist: np.ndarray         # (K, 2), zero-padded
    dist_size: np.ndarray    # int32 (K,)
    ext_rot: np.ndarray      # (E, 3) angle-axis
    ext_trans: np.ndarray    # (E, 3)
    points: np.ndarray       # (N, 3) starting structure
    colors: np.ndarray       # int32 (N, 3)

    @property
    def n_obs(self) -> int:
        return int(self.obs_point.shape[0])

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    @property
    def n_extrinsics(self) -> int:
        return int(self.ext_rot.shape[0])

    @property
    def n_intrinsics(self) -> int:
        return int(self.center.shape[0])


def _look_at(pos: np.ndarray, target: np.ndarray) -> tuple:
    """World -> camera (R, t): z forward to the target, y the world's down
    projected."""
    f = target - pos
    f = f / np.linalg.norm(f)
    r = np.cross(np.array([0.0, 1.0, 0.0]), f)
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    R = np.stack([r, d, f], axis=0)
    return R, -R @ pos


def _matrix_to_angle_axis(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> angle-axis through the quaternion (Shepperd)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    w, xyz = q[0], q[1:]
    sin_half = np.sqrt(float(np.dot(xyz, xyz)))
    if sin_half < 1e-12:
        return 2.0 * xyz
    two_theta = (2.0 * np.arctan2(-sin_half, -w) if w < 0
                 else 2.0 * np.arctan2(sin_half, w))
    return xyz * (two_theta / sin_half)


def _rotate(aa, p):
    """Rodrigues rotation of points ``p`` (..., 3) by angle-axis ``aa``."""
    import torch

    aa, p = torch.broadcast_tensors(aa, p)
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = theta2 < 1e-24
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    w = aa / theta
    c, s = torch.cos(theta), torch.sin(theta)
    wp = torch.sum(w * p, dim=-1, keepdim=True)
    large = c * p + s * torch.linalg.cross(w, p) + (1.0 - c) * wp * w
    return torch.where(small, p + torch.linalg.cross(aa, p), large)


def _project(p, focal, d0, d1, center):
    """Pixel (u, v) of camera-frame points ``p`` (..., 3)."""
    xp, yp = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
    r2 = xp * xp + yp * yp
    dist = 1.0 + r2 * (d0 + d1 * r2)
    return (focal * dist * xp + center[..., 0],
            focal * dist * yp + center[..., 1])


def _ball(gen, n, radius, center, dtype, device):
    """``n`` points uniform in a ball, and their unit directions."""
    import torch

    direction = torch.randn((n, 3), generator=gen, dtype=dtype,
                            device=device)
    direction = direction / torch.clamp(
        torch.linalg.norm(direction, dim=1, keepdim=True), min=1e-9)
    radii = radius * torch.pow(
        torch.rand((n, 1), generator=gen, dtype=dtype, device=device),
        1.0 / 3.0)
    c = torch.tensor(center, dtype=dtype, device=device)
    return c + direction * radii, direction


def rig_tables(cfg: dict) -> dict:
    """The turntable rig's camera records (``.deeparc`` layout: record 0
    the shared arc-0 / ring-0 slot, arcs at records 1..A-1, ring r >= 1 at
    record r + A - 1) and intrinsics, as numpy arrays."""
    A, R = cfg["n_arc"], cfg["n_ring"]
    rho = cfg["rho"]
    c_obj = np.array([0.0, 0.0, rho])
    ext_rot = np.zeros((A + R - 1, 3))
    ext_trans = np.zeros((A + R - 1, 3))
    max_elev = np.deg2rad(cfg["max_elevation_deg"])
    for a in range(1, A):
        theta = max_elev * a / max(A - 1, 1)
        pos = c_obj + np.array([0.0, -rho * np.sin(theta),
                                -rho * np.cos(theta)])
        Rm, t = _look_at(pos, c_obj)
        ext_rot[a] = _matrix_to_angle_axis(Rm)
        ext_trans[a] = t
    for r in range(1, R):
        phi = 2.0 * np.pi * r / R
        c, s = np.cos(phi), np.sin(phi)
        Ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        ext_rot[A - 1 + r] = [0.0, phi, 0.0]
        ext_trans[A - 1 + r] = c_obj - Ry @ c_obj
    w, h = cfg["image_size"]
    return dict(ext_rot=ext_rot, ext_trans=ext_trans,
                center=np.tile([w / 2.0, h / 2.0], (A, 1)),
                focal=np.tile([cfg["focal"], 0.0], (A, 1)))


def _rig(cfg, traffic, gen, device, dtype):
    import torch

    A, R = cfg["n_arc"], cfg["n_ring"]
    tab = rig_tables(cfg)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    ext_rot, ext_trans = t(tab["ext_rot"]), t(tab["ext_trans"])
    w, h = cfg["image_size"]
    n = cfg["n_points"]
    gt, direction = _ball(gen, n, cfg["object_radius"],
                          (0.0, 0.0, cfg["rho"]), dtype, device)
    colors = torch.randint(0, 256, (n, 3), generator=gen, device=device)
    occl = traffic.get("occlusion_rings")
    if occl is not None:
        alpha = torch.atan2(direction[:, 0], direction[:, 2])
        cos_half = float(np.cos(np.pi * occl / R))
    vis = traffic["visibility"]
    cols = {"arc": [], "ring": [], "point": [], "u": [], "v": []}
    for a in range(A):
        for r in range(R):
            ring_rec = 0 if r == 0 else r + A - 1
            if r == 0:
                outer, inner = a, None
            elif a == 0:
                outer, inner = ring_rec, None
            else:
                outer, inner = a, ring_rec
            p = gt
            if inner is not None:
                p = _rotate(ext_rot[inner], p) + ext_trans[inner]
            p = _rotate(ext_rot[outer], p) + ext_trans[outer]
            z_ok = p[:, 2] > 0.2
            p = torch.where(z_ok[:, None], p, torch.ones_like(p))
            u, v = _project(p, cfg["focal"], 0.0, 0.0,
                            t(tab["center"][a]))
            seen = z_ok & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            if occl is not None:
                phi = 2.0 * np.pi * r / R
                seen &= torch.cos(alpha + phi - np.pi) > cos_half
            seen &= torch.rand((n,), generator=gen, dtype=dtype,
                               device=device) < vis
            idx = torch.nonzero(seen)[:, 0]
            cols["arc"].append(torch.full_like(idx, a))
            cols["ring"].append(torch.full_like(idx, r))
            cols["point"].append(idx)
            cols["u"].append(u[idx])
            cols["v"].append(v[idx])
    cat = {k: torch.cat(v) for k, v in cols.items()}
    xy = torch.stack([cat["u"], cat["v"]], dim=1)
    xy = xy + cfg["pixel_noise"] * torch.randn(
        xy.shape, generator=gen, dtype=dtype, device=device)
    # points seen fewer than twice are dropped and the rest re-indexed
    counts = torch.bincount(cat["point"], minlength=n)
    keep = counts >= cfg["min_track_length"]
    new_index = torch.cumsum(keep.to(torch.int64), 0) - 1
    live = keep[cat["point"]]
    gt, colors = gt[keep], colors[keep]
    points = gt + cfg["point_noise"] * torch.randn(
        gt.shape, generator=gen, dtype=dtype, device=device)
    K = A
    host = lambda x: x.cpu().numpy()
    return DeepArcArrays(
        version=0.01, share_extrinsic=True, arc_size=A, ring_size=R,
        obs_arc=host(cat["arc"][live]).astype(np.int32),
        obs_ring=host(cat["ring"][live]).astype(np.int32),
        obs_point=host(new_index[cat["point"][live]]).astype(np.int32),
        obs_xy=host(xy[live]).astype(np.float64),
        center=tab["center"], focal=tab["focal"],
        focal_size=np.ones(K, np.int32), dist=np.zeros((K, 2)),
        dist_size=np.zeros(K, np.int32),
        ext_rot=tab["ext_rot"], ext_trans=tab["ext_trans"],
        points=host(points).astype(np.float64),
        colors=host(colors).astype(np.int32))


def track_lengths(gen, cfg, traffic, device):
    """Per-point track lengths: a clipped log-normal of the configuration's
    mean, then single increments or decrements at points drawn from the
    seed until the total is the configuration's observation count."""
    import torch

    n, target = cfg["n_points"], cfg["n_observations"]
    lo, hi = traffic["track_min"], min(traffic["track_clip"],
                                       cfg["n_cameras"])
    if not lo * n <= target <= hi * n:
        raise ValueError(f"{target} observations do not fit {n} tracks "
                         f"of {lo}..{hi}")
    sigma = traffic["track_sigma"]
    mu = np.log(target / n) - 0.5 * sigma * sigma
    z = torch.randn((n,), generator=gen, dtype=torch.float64, device=device)
    track = torch.clamp(torch.round(torch.exp(mu + sigma * z)), lo,
                        hi).to(torch.int64)
    while True:
        diff = target - int(track.sum())
        if diff == 0:
            return track
        room = track < hi if diff > 0 else track > lo
        cand = torch.nonzero(room)[:, 0]
        pick = cand[torch.randint(0, cand.numel(), (min(abs(diff),
                                                        cand.numel()),),
                                  generator=gen, device=device)]
        step = torch.zeros_like(track).index_add_(
            0, pick, torch.ones_like(pick))
        track = torch.clamp(track + (1 if diff > 0 else -1)
                            * torch.clamp(step, max=1), lo, hi)


def bal_tables(cfg: dict, gen, device) -> dict:
    """BAL cameras on a view sphere ordered by azimuth, looking at the
    origin; one intrinsic each (focal jittered, two distortion terms)."""
    import torch

    n = cfg["n_cameras"]
    dirs = torch.randn((n, 3), generator=gen, dtype=torch.float64,
                       device=device).cpu().numpy()
    jitter = torch.randn((n,), generator=gen, dtype=torch.float64,
                         device=device).cpu().numpy()
    dirs[:, 1] = np.clip(dirs[:, 1], -0.9, 0.9)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = dirs[np.argsort(np.arctan2(dirs[:, 2], dirs[:, 0]))]
    ext_rot, ext_trans = np.zeros((n, 3)), np.zeros((n, 3))
    for c in range(n):
        Rm, t = _look_at(cfg["rho"] * dirs[c], np.zeros(3))
        ext_rot[c] = _matrix_to_angle_axis(Rm)
        ext_trans[c] = t
    w, h = cfg["image_size"]
    focal = np.zeros((n, 2))
    focal[:, 0] = cfg["focal"] * (1.0 + cfg["focal_jitter"] * jitter)
    return dict(ext_rot=ext_rot, ext_trans=ext_trans,
                center=np.tile([w / 2.0, h / 2.0], (n, 1)), focal=focal,
                dist=np.tile(cfg["distortion"], (n, 1)))


def _start_cameras(tab, noise, gen, device) -> dict:
    """The starting cameras: the true ones with Gaussian noise of the
    configuration's ``camera_noise`` (radians on each angle-axis
    component, units on each translation component, a share of the focal
    length, and units on k1 and k2), as an incremental reconstruction hands
    BAL its initial estimates; camera 0, the gauge, keeps its true pose."""
    import torch

    out = {k: tab[k].copy() for k in ("ext_rot", "ext_trans", "focal",
                                      "dist")}
    if not noise:
        return out
    n = tab["ext_rot"].shape[0]
    draw = lambda *shape: torch.randn(shape, generator=gen,
                                      dtype=torch.float64,
                                      device=device).cpu().numpy()
    rot, trans, focal, dist = draw(n, 3), draw(n, 3), draw(n), draw(n, 2)
    rot[0] = trans[0] = 0.0
    out["ext_rot"] += noise["rotation"] * rot
    out["ext_trans"] += noise["translation"] * trans
    out["focal"][:, 0] *= 1.0 + noise["focal"] * focal
    out["dist"] += np.array([noise["k1"], noise["k2"]]) * dist
    return out


def _distinct_offsets(gen, rows, track, window, device):
    """(rows, max track) offsets in [0, window), the first ``track`` of
    each row distinct: the ranks of random keys."""
    import torch

    keys = torch.rand((rows, window), generator=gen, device=device)
    return torch.argsort(keys, dim=1)[:, : int(track.max())]


def _bal(cfg, traffic, gen, device, dtype):
    import torch

    n, V = cfg["n_points"], cfg["n_cameras"]
    tab = bal_tables(cfg, gen, device)
    track = track_lengths(gen, cfg, traffic, device)
    gt, _ = _ball(gen, n, cfg["object_radius"], (0.0, 0.0, 0.0), dtype,
                  device)
    colors = torch.randint(0, 256, (n, 3), generator=gen, device=device)
    start = torch.randint(0, V, (n,), generator=gen, device=device)
    # a point's cameras: distinct, from a window of consecutive cameras
    # (cyclic in azimuth); a track longer than half the window draws from
    # a window twice its length
    base = traffic["window"]
    wide = track * 2 > base
    cam = torch.zeros((n, int(track.max())), dtype=torch.int64, device=device)
    for sel, win in ((~wide, base), (wide, None)):
        rows = torch.nonzero(sel)[:, 0]
        if rows.numel() == 0:
            continue
        w = win or min(V, 2 * int(track[rows].max()))
        off = _distinct_offsets(gen, rows.numel(), track[rows], w, device)
        cam[rows, : off.shape[1]] = (start[rows, None] + off) % V
    slot = torch.arange(cam.shape[1], device=device)
    live = slot[None, :] < track[:, None]
    obs_point = torch.nonzero(live)[:, 0]
    obs_cam = cam[live]
    # cameras in ascending id within each track
    order = torch.argsort(obs_point * V + obs_cam)
    obs_point, obs_cam = obs_point[order], obs_cam[order]
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    rot, trans = t(tab["ext_rot"])[obs_cam], t(tab["ext_trans"])[obs_cam]
    dist = t(tab["dist"])[obs_cam]
    p = _rotate(rot, gt[obs_point]) + trans
    u, v = _project(p, t(tab["focal"])[obs_cam, 0], dist[:, 0],
                    dist[:, 1], t(tab["center"])[obs_cam])
    xy = torch.stack([u, v], dim=1)
    xy = xy + cfg["pixel_noise"] * torch.randn(
        xy.shape, generator=gen, dtype=dtype, device=device)
    points = gt + cfg["point_noise"] * torch.randn(
        gt.shape, generator=gen, dtype=dtype, device=device)
    start = _start_cameras(tab, cfg.get("camera_noise"), gen, device)
    host = lambda x: x.cpu().numpy()
    obs_cam_h = host(obs_cam).astype(np.int32)
    return DeepArcArrays(
        version=0.01, share_extrinsic=False, arc_size=V, ring_size=0,
        obs_arc=obs_cam_h, obs_ring=obs_cam_h.copy(),
        obs_point=host(obs_point).astype(np.int32),
        obs_xy=host(xy).astype(np.float64),
        center=tab["center"], focal=start["focal"],
        focal_size=np.ones(V, np.int32), dist=start["dist"],
        dist_size=np.full(V, 2, np.int32),
        ext_rot=start["ext_rot"], ext_trans=start["ext_trans"],
        points=host(points).astype(np.float64),
        colors=host(colors).astype(np.int32))


GENERATORS = {"rig": _rig, "bal": _bal}


def relabel(data: DeepArcArrays, gen, device) -> DeepArcArrays:
    """The same scene in another order, drawn from ``gen``: the points
    renumbered and the observations shuffled; the cameras, and so the
    gauge, stay."""
    import torch

    n, m = data.n_points, data.n_obs
    new_id = torch.randperm(n, generator=gen, device=device).cpu().numpy()
    order = torch.randperm(m, generator=gen, device=device).cpu().numpy()
    points, colors = np.empty_like(data.points), np.empty_like(data.colors)
    points[new_id], colors[new_id] = data.points, data.colors
    return dataclasses.replace(
        data, obs_arc=data.obs_arc[order], obs_ring=data.obs_ring[order],
        obs_point=new_id[data.obs_point[order]].astype(np.int32),
        obs_xy=data.obs_xy[order], points=points, colors=colors)


def make(cfg: dict, traffic: dict, seed: int, device) -> DeepArcArrays:
    """The scene of ``cfg`` under ``traffic`` on ``device``, returned on
    the host. Drawn from ``seed``; or, where the configuration fixes a
    ``scene_seed`` (its solve's LM iteration count changes with the
    noise's draw), drawn from that and given in the order ``seed`` draws,
    so every seed asks for the same work."""
    import torch

    kind = traffic["generator"]
    if kind not in GENERATORS:
        raise ValueError(f"unknown generator {kind!r}; one of "
                         f"{sorted(GENERATORS)}")
    gen = lambda s: torch.Generator(device=device).manual_seed(
        int(s) % (1 << 63))
    if "scene_seed" not in cfg:
        return GENERATORS[kind](cfg, traffic, gen(seed), device,
                                torch.float64)
    data = GENERATORS[kind](cfg, traffic, gen(cfg["scene_seed"]), device,
                            torch.float64)
    return relabel(data, gen(seed), device)

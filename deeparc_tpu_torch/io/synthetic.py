"""Synthetic problem generators with ground truth (numpy only), the port's
own copy of the host-side generators of ``deeparc_tpu.io.synthetic``.

  make_hemisphere_rig     shared-extrinsic turntable rig: an object on a
                          turntable (the "rings") seen by cameras along a
                          meridian arc (the "arcs"), composed extrinsics
                          ``p = R_arc (R_ring X + t_ring) + t_arc``
                          (``src/snavely_reprojection_error.hh:96-108``),
                          record 0 = identity, arc a >= 1 at record a, ring
                          r >= 1 at record ``r + n_arc - 1``
                          (``src/DeepArcManager.cc:166-171``);
  make_bal_synthetic      non-shared (BAL-style) cameras on a view sphere;
  make_bal_windowed_host  BAL-style ring capture with windowed tracks, hub
                          cameras and shuffled camera ids.

The same seed gives the same arrays as the reference package's generators.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from deeparc_tpu_torch.io.deeparc_format import DeepArcData


@dataclasses.dataclass
class SyntheticRig:
    data: DeepArcData          # noisy problem, as would be loaded from disk
    gt_points: np.ndarray      # (N, 3) ground-truth structure
    gt_ext_rot: np.ndarray     # (E, 3) ground-truth extrinsics
    gt_ext_trans: np.ndarray   # (E, 3)
    image_size: tuple          # (width, height)


def _look_at(pos: np.ndarray, target: np.ndarray) -> tuple:
    """World->camera (R, t): z = forward to target, y = world-down projected."""
    f = target - pos
    f = f / np.linalg.norm(f)
    down_hint = np.array([0.0, 1.0, 0.0])
    r = np.cross(down_hint, f)
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    R = np.stack([r, d, f], axis=0)
    t = -R @ pos
    return R, t


def _rotmat_to_aa(R: np.ndarray) -> np.ndarray:
    from deeparc_tpu_torch.io.deeparc_format import _np_matrix_to_angle_axis

    return _np_matrix_to_angle_axis(R.reshape(9, order="F"))


def make_hemisphere_rig(
    n_arc: int = 4,
    n_ring: int = 8,
    n_points: int = 500,
    rho: float = 2.0,
    object_radius: float = 0.4,
    focal: float = 1000.0,
    image_size: tuple = (1600, 1200),
    focal_size: int = 1,
    dist_size: int = 0,
    dist_coeffs: tuple = (-0.05, 0.01),
    pixel_noise: float = 0.0,
    point_noise: float = 0.0,
    ext_noise: float = 0.0,
    random_points: bool = False,
    visibility: float = 1.0,
    occlusion_rings: int | None = None,
    min_track_length: int = 2,
    seed: int = 0,
) -> SyntheticRig:
    """Build a shared-extrinsic rig problem with known ground truth.

    ``occlusion_rings`` models self-occlusion (the visibility structure a
    real turntable capture has): a surface point is only seen while the
    turntable faces it toward the camera meridian — a contiguous cyclic
    window of that many rotation steps.

    ``random_points=True`` reproduces the ``teabottle_green_randompoint``
    configuration (BASELINE.json config 2): structure initialized uniformly at
    random in the object's bounding box instead of near the truth.

    ``ext_noise`` perturbs the STORED extrinsics (angle-axis radians and
    translation units, rows >= 1 — the identity/gauge slot stays exact)
    while observations are projected from the true cameras: the realistic
    SfM condition where the full-BA rounds of the pipeline loop actually
    move the cameras, unlike the exact-camera default.
    """
    rng = np.random.default_rng(seed)
    c_obj = np.array([0.0, 0.0, rho])

    # --- ground-truth extrinsic records -----------------------------------
    n_ext = n_arc + n_ring - 1
    ext_rot = np.zeros((n_ext, 3))
    ext_trans = np.zeros((n_ext, 3))
    # arcs (record a, a >= 1): look-at cameras at elevation theta_a on the
    # meridian circle of radius rho around the object center (x = 0 plane).
    max_elev = np.deg2rad(70.0)
    for a in range(1, n_arc):
        theta = max_elev * a / max(n_arc - 1, 1)
        pos = c_obj + np.array(
            [0.0, -rho * np.sin(theta), -rho * np.cos(theta)]
        )
        R, t = _look_at(pos, c_obj)
        ext_rot[a] = _rotmat_to_aa(R)
        ext_trans[a] = t
    # rings (record r + n_arc - 1, r >= 1): turntable rotation by phi about
    # the vertical (y) axis through the object center: X' = Ry(X - c) + c.
    for r in range(1, n_ring):
        phi = 2.0 * np.pi * r / n_ring
        aa = np.array([0.0, phi, 0.0])
        cphi, sphi = np.cos(phi), np.sin(phi)
        Ry = np.array([[cphi, 0, sphi], [0, 1, 0], [-sphi, 0, cphi]])
        ext_rot[n_arc - 1 + r] = aa
        ext_trans[n_arc - 1 + r] = c_obj - Ry @ c_obj

    # --- ground-truth structure ------------------------------------------
    pts = rng.normal(size=(n_points, 3))
    pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-9)
    radii = object_radius * np.cbrt(rng.uniform(size=(n_points, 1)))
    gt_points = c_obj + pts * radii
    colors = rng.integers(0, 256, size=(n_points, 3)).astype(np.int32)

    # --- intrinsics (one per arc, shared around each ring;
    #     src/DeepArcManager.cc:210-214) ----------------------------------
    K = n_arc
    cx, cy = image_size[0] / 2.0, image_size[1] / 2.0
    center = np.tile([cx, cy], (K, 1))
    focal_arr = np.zeros((K, 2))
    focal_arr[:, 0] = focal
    if focal_size == 2:
        focal_arr[:, 1] = focal * 1.01
    dist_arr = np.zeros((K, 2))
    if dist_size >= 1:
        dist_arr[:, 0] = dist_coeffs[0]
    if dist_size == 2:
        dist_arr[:, 1] = dist_coeffs[1]

    # --- project every point into every (arc, ring) cell ------------------
    # Composed model exactly as the residual evaluates it.

    def cell_extrinsics(a, r):
        """(outer R|t, inner R|t) per reference slot rules (ParameterBlock.hh:75-92)."""
        ring_rec = 0 if r == 0 else r + n_arc - 1
        if r == 0:
            return a, None
        if a == 0:
            return ring_rec, None
        return a, ring_rec

    def aa_to_R(aa):
        th = np.linalg.norm(aa)
        if th < 1e-12:
            return np.eye(3)
        w = aa / th
        Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)

    obs_arc, obs_ring, obs_point, obs_xy = [], [], [], []
    w_img, h_img = image_size
    if occlusion_rings is not None:
        d_obj = gt_points - c_obj
        alpha = np.arctan2(d_obj[:, 0], d_obj[:, 2])
        half_w = np.pi * occlusion_rings / n_ring
    for a in range(n_arc):
        for r in range(n_ring):
            outer, inner = cell_extrinsics(a, r)
            p = gt_points
            if inner is not None:
                p = p @ aa_to_R(ext_rot[inner]).T + ext_trans[inner]
            p = p @ aa_to_R(ext_rot[outer]).T + ext_trans[outer]
            z_ok = p[:, 2] > 0.2
            xp = p[:, 0] / np.where(z_ok, p[:, 2], 1.0)
            yp = p[:, 1] / np.where(z_ok, p[:, 2], 1.0)
            r2 = xp * xp + yp * yp
            d0 = dist_arr[a, 0] if dist_size >= 1 else 0.0
            d1 = dist_arr[a, 1] if dist_size == 2 else 0.0
            distortion = 1.0 + r2 * (d0 + d1 * r2)
            fx = focal_arr[a, 0]
            fy = focal_arr[a, 1] if focal_size == 2 else focal_arr[a, 0]
            u = fx * distortion * xp + cx
            v = fy * distortion * yp + cy
            in_img = z_ok & (u >= 0) & (u < w_img) & (v >= 0) & (v < h_img)
            if occlusion_rings is not None:
                phi = 2.0 * np.pi * r / n_ring
                in_img &= np.cos(alpha + phi - np.pi) > np.cos(half_w)
            if visibility < 1.0:
                in_img &= rng.uniform(size=n_points) < visibility
            idx = np.nonzero(in_img)[0]
            obs_arc.append(np.full(idx.shape, a, dtype=np.int32))
            obs_ring.append(np.full(idx.shape, r, dtype=np.int32))
            obs_point.append(idx.astype(np.int32))
            xy = np.stack([u[idx], v[idx]], axis=1)
            obs_xy.append(xy)

    obs_arc = np.concatenate(obs_arc)
    obs_ring = np.concatenate(obs_ring)
    obs_point = np.concatenate(obs_point)
    obs_xy = np.concatenate(obs_xy, axis=0)
    if pixel_noise > 0:
        obs_xy = obs_xy + rng.normal(scale=pixel_noise, size=obs_xy.shape)

    # Drop points with short tracks, then re-index densely.
    counts = np.bincount(obs_point, minlength=n_points)
    keep = counts >= min_track_length
    new_index = np.cumsum(keep) - 1
    mask = keep[obs_point]
    obs_arc, obs_ring = obs_arc[mask], obs_ring[mask]
    obs_point = new_index[obs_point[mask]].astype(np.int32)
    obs_xy = obs_xy[mask]
    gt_points = gt_points[keep]
    colors = colors[keep]
    n_points = gt_points.shape[0]

    # --- initial (noisy) structure ---------------------------------------
    if random_points:
        lo = c_obj - object_radius
        hi = c_obj + object_radius
        init_points = rng.uniform(lo, hi, size=(n_points, 3))
    elif point_noise > 0:
        init_points = gt_points + rng.normal(scale=point_noise, size=(n_points, 3))
    else:
        init_points = gt_points.copy()

    init_ext_rot, init_ext_trans = ext_rot.copy(), ext_trans.copy()
    if ext_noise > 0:
        init_ext_rot[1:] += rng.normal(scale=ext_noise, size=(n_ext - 1, 3))
        init_ext_trans[1:] += rng.normal(scale=ext_noise, size=(n_ext - 1, 3))

    data = DeepArcData(
        version=0.01, share_extrinsic=True, arc_size=n_arc, ring_size=n_ring,
        obs_arc=obs_arc, obs_ring=obs_ring, obs_point=obs_point, obs_xy=obs_xy,
        center=center, focal=focal_arr,
        focal_size=np.full(K, focal_size, dtype=np.int32),
        dist=dist_arr, dist_size=np.full(K, dist_size, dtype=np.int32),
        ext_rot=init_ext_rot, ext_trans=init_ext_trans,
        points=init_points, colors=colors,
    )
    return SyntheticRig(
        data=data, gt_points=gt_points, gt_ext_rot=ext_rot,
        gt_ext_trans=ext_trans, image_size=image_size,
    )


def make_bal_synthetic(
    n_cameras: int = 16,
    n_points: int = 400,
    rho: float = 3.0,
    object_radius: float = 1.0,
    focal: float = 800.0,
    track_length: float = 6.0,
    min_track_length: int = 2,
    dist_size: int = 2,
    dist_coeffs: tuple = (-0.02, 0.005),
    pixel_noise: float = 0.0,
    point_noise: float = 0.0,
    ext_noise: float = 0.0,
    seed: int = 0,
) -> SyntheticRig:
    """Non-shared-extrinsic (BAL-style) synthetic problem with ground truth.

    ``ext_noise`` perturbs the INITIAL extrinsics (angle-axis and
    translation) away from the ground truth used for projection — the
    noisy-registration configuration pose-graph refinement targets.

    Cameras are scattered on a sphere of radius ``rho`` looking at a point
    cloud at the origin — the arbitrary camera-graph case the reference
    handles through its non-shared mode (``src/ParameterBlock.hh:52-55``:
    obs columns are (intrinsic_id, extrinsic_id) directly) and Ceres solves
    with sparse DENSE_SCHUR. Each camera is one intrinsic + one extrinsic;
    every point sees a random camera subset with mean ``track_length``.
    """
    rng = np.random.default_rng(seed)

    # --- camera poses on a view sphere ------------------------------------
    ext_rot = np.zeros((n_cameras, 3))
    ext_trans = np.zeros((n_cameras, 3))
    dirs = rng.normal(size=(n_cameras, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    # avoid the degenerate straight-down axis for the look-at up-hint
    dirs[:, 1] = np.clip(dirs[:, 1], -0.9, 0.9)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for c in range(n_cameras):
        pos = rho * dirs[c]
        R, t = _look_at(pos, np.zeros(3))
        ext_rot[c] = _rotmat_to_aa(R)
        ext_trans[c] = t

    # --- structure ---------------------------------------------------------
    pts = rng.normal(size=(n_points, 3))
    pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-9)
    gt_points = pts * object_radius * np.cbrt(rng.uniform(size=(n_points, 1)))
    colors = rng.integers(0, 256, size=(n_points, 3)).astype(np.int32)

    # --- intrinsics: one per camera ----------------------------------------
    image_size = (1024, 1024)
    cx, cy = image_size[0] / 2.0, image_size[1] / 2.0
    center = np.tile([cx, cy], (n_cameras, 1))
    focal_arr = np.zeros((n_cameras, 2))
    focal_arr[:, 0] = focal * (1.0 + 0.05 * rng.normal(size=n_cameras))
    dist_arr = np.zeros((n_cameras, 2))
    if dist_size >= 1:
        dist_arr[:, 0] = dist_coeffs[0]
    if dist_size == 2:
        dist_arr[:, 1] = dist_coeffs[1]

    def aa_to_R(aa):
        th = np.linalg.norm(aa)
        if th < 1e-12:
            return np.eye(3)
        w = aa / th
        Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)

    visibility = min(track_length / n_cameras, 1.0)
    obs_cam, obs_point, obs_xy = [], [], []
    w_img, h_img = image_size
    for c in range(n_cameras):
        p = gt_points @ aa_to_R(ext_rot[c]).T + ext_trans[c]
        z_ok = p[:, 2] > 0.2
        xp = p[:, 0] / np.where(z_ok, p[:, 2], 1.0)
        yp = p[:, 1] / np.where(z_ok, p[:, 2], 1.0)
        r2 = xp * xp + yp * yp
        distortion = 1.0 + r2 * (dist_arr[c, 0] + dist_arr[c, 1] * r2)
        u = focal_arr[c, 0] * distortion * xp + cx
        v = focal_arr[c, 0] * distortion * yp + cy
        in_img = z_ok & (u >= 0) & (u < w_img) & (v >= 0) & (v < h_img)
        in_img &= rng.uniform(size=n_points) < visibility
        idx = np.nonzero(in_img)[0]
        obs_cam.append(np.full(idx.shape, c, dtype=np.int32))
        obs_point.append(idx.astype(np.int32))
        obs_xy.append(np.stack([u[idx], v[idx]], axis=1))

    obs_cam = np.concatenate(obs_cam)
    obs_point = np.concatenate(obs_point)
    obs_xy = np.concatenate(obs_xy, axis=0)
    if pixel_noise > 0:
        obs_xy = obs_xy + rng.normal(scale=pixel_noise, size=obs_xy.shape)

    counts = np.bincount(obs_point, minlength=n_points)
    keep = counts >= min_track_length
    new_index = np.cumsum(keep) - 1
    mask = keep[obs_point]
    obs_cam = obs_cam[mask]
    obs_point = new_index[obs_point[mask]].astype(np.int32)
    obs_xy = obs_xy[mask]
    gt_points = gt_points[keep]
    colors = colors[keep]
    n_points = gt_points.shape[0]

    init_points = gt_points + (
        rng.normal(scale=point_noise, size=(n_points, 3))
        if point_noise > 0 else 0.0
    )
    init_rot = ext_rot.copy()
    init_trans = ext_trans.copy()
    if ext_noise > 0:
        # keep the gauge camera (record 0) exact
        init_rot[1:] += rng.normal(scale=ext_noise, size=(n_cameras - 1, 3))
        init_trans[1:] += rng.normal(scale=ext_noise, size=(n_cameras - 1, 3))

    data = DeepArcData(
        version=0.01, share_extrinsic=False, arc_size=n_cameras, ring_size=0,
        obs_arc=obs_cam, obs_ring=obs_cam.copy(), obs_point=obs_point,
        obs_xy=obs_xy,
        center=center, focal=focal_arr,
        focal_size=np.ones(n_cameras, dtype=np.int32),
        dist=dist_arr, dist_size=np.full(n_cameras, dist_size, dtype=np.int32),
        ext_rot=init_rot, ext_trans=init_trans,
        points=np.asarray(init_points), colors=colors,
    )
    return SyntheticRig(
        data=data, gt_points=gt_points, gt_ext_rot=ext_rot,
        gt_ext_trans=ext_trans, image_size=image_size,
    )


def make_bal_windowed_host(
    n_cameras: int = 2000,
    n_points: int = 250_000,
    track_length: int = 8,
    window: int = 128,
    n_hubs: int = 8,
    hub_frac: float = 0.15,
    rho: float = 3.0,
    object_radius: float = 1.0,
    focal: float = 800.0,
    pixel_noise: float = 1.0,
    point_noise: float = 0.02,
    shuffle_ids: bool = True,
    seed: int = 0,
):
    """Host-side windowed BAL scene with HUB contamination and shuffled
    camera ids — the graph shape that exercises the tile engine's
    hub-robust locality ordering (solver/tiles._locality_cell_order).

    Cameras sit on a ring around the object (a capture path); each point
    is seen by ``track_length`` cameras from a contiguous latent window,
    except that with probability ``hub_frac`` an observation is replaced
    by one of ``n_hubs`` elevated hub cameras that see everything (the
    popular-view contamination of real photo collections). Camera ids are
    then shuffled so no input ordering survives; only the co-visibility
    structure remains for tiles_from_scene to find. Returns a
    :class:`deeparc_tpu_torch.io.deeparc_format.DeepArcData` (non-shared mode,
    ``src/ParameterBlock.hh:52-55`` wiring).
    """
    from deeparc_tpu_torch.io.deeparc_format import DeepArcData

    rng = np.random.default_rng(seed)
    n_win = n_cameras - n_hubs

    # ring cameras + elevated hubs, all looking at the origin
    ext_rot = np.zeros((n_cameras, 3))
    ext_trans = np.zeros((n_cameras, 3))
    az = 2.0 * np.pi * np.arange(n_win) / n_win
    pos = np.stack([rho * np.cos(az), 0.25 * rho * np.ones(n_win),
                    rho * np.sin(az)], axis=1)
    az_h = 2.0 * np.pi * np.arange(max(n_hubs, 1)) / max(n_hubs, 1)
    pos_h = np.stack([0.6 * rho * np.cos(az_h),
                      1.1 * rho * np.ones(max(n_hubs, 1)),
                      0.6 * rho * np.sin(az_h)], axis=1)[:n_hubs]
    for c, p in enumerate(np.concatenate([pos, pos_h])):
        R, t = _look_at(p, np.zeros(3))
        ext_rot[c] = _rotmat_to_aa(R)
        ext_trans[c] = t

    pts = rng.normal(size=(n_points, 3))
    pts /= np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-9)
    gt = pts * object_radius * np.cbrt(rng.uniform(size=(n_points, 1)))

    # latent window start per point (progressive around the ring), with
    # W distinct window picks via the sorted-draw + rank-offset trick
    W = track_length
    starts = (np.arange(n_points, dtype=np.int64) * n_win) // n_points
    draw = rng.integers(0, window - W + 1, size=(n_points, W))
    local = np.sort(draw, axis=1) + np.arange(W)[None, :]
    cams = (starts[:, None] + local) % n_win
    # hub substitution
    hub_pick = rng.random((n_points, W)) < hub_frac
    if n_hubs:
        hub_ids = n_win + rng.integers(0, n_hubs, size=(n_points, W))
        cams = np.where(hub_pick, hub_ids, cams)

    obs_point = np.repeat(np.arange(n_points, dtype=np.int64), W)
    obs_cam = cams.reshape(-1)

    # project (vectorized per observation)
    from scipy.spatial.transform import Rotation

    R_all = Rotation.from_rotvec(ext_rot).as_matrix()
    p_cam = (np.einsum("mij,mj->mi", R_all[obs_cam], gt[obs_point])
             + ext_trans[obs_cam])
    z = np.maximum(p_cam[:, 2], 0.2)
    uv = focal * p_cam[:, :2] / z[:, None] + 512.0
    uv += pixel_noise * rng.normal(size=uv.shape)

    if shuffle_ids:
        # old camera o gets new id inv[o]; camera arrays re-indexed so the
        # new id slots hold the right parameters (new row n = old shuffle[n])
        shuffle = rng.permutation(n_cameras)
        inv = np.empty(n_cameras, np.int64)
        inv[shuffle] = np.arange(n_cameras)
        obs_cam = inv[obs_cam]
        ext_rot = ext_rot[shuffle]
        ext_trans = ext_trans[shuffle]
    obs_cam = obs_cam.astype(np.int32)

    init_pts = gt + point_noise * rng.normal(size=gt.shape)
    return DeepArcData(
        version=0.01, share_extrinsic=False,
        arc_size=n_cameras, ring_size=0,
        obs_arc=obs_cam, obs_ring=obs_cam.copy(),
        obs_point=obs_point.astype(np.int32),
        obs_xy=uv,
        center=np.tile([512.0, 512.0], (n_cameras, 1)),
        focal=np.concatenate(
            [np.full((n_cameras, 1), focal), np.zeros((n_cameras, 1))],
            axis=1),
        focal_size=np.ones(n_cameras, dtype=np.int32),
        dist=np.zeros((n_cameras, 2)),
        dist_size=np.zeros(n_cameras, dtype=np.int32),
        ext_rot=ext_rot, ext_trans=ext_trans,
        points=init_pts,
        colors=rng.integers(0, 256, size=(n_points, 3)).astype(np.int32),
    )

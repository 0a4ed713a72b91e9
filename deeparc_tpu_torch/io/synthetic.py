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

The device-side generators build a benchmark-scale problem directly in a
solver's layout on the device; only the small camera tables cross from the
host:

  make_grid_rig_device       the turntable rig as a dense (N, T) grid;
  make_tile_rig_device       the rig as one (N, W) tile bucket, each point
                             seeing ``track_length`` random cells;
  make_bal_tile_device       BAL-style cameras, one (N, W) bucket, tracks
                             from a sliding camera window (or uniform);
  make_bal_heavytail_device  BAL-style cameras with log-normal track
                             lengths laid out in buckets of several widths.

Their draws on the device come from a ``torch.Generator`` seeded with
``seed``, so they are not the reference's numbers (its threefry streams
cannot be matched); everything drawn on the host (the camera tables, the
heavy-tailed track lengths) and every layout table is the reference's.
They import torch and the solver lazily, so this module stays numpy-only
to import.
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


# ---------------------------------------------------------------------------
# Device-side generators
# ---------------------------------------------------------------------------


def _device_setup(device, seed, dtype):
    """(device, generator, dtype) of a device-side generator: the device as
    ``check_device`` gives it (no fall-back), a generator of its own seeded
    with ``seed``, float32 by default."""
    import torch

    from deeparc_tpu_torch.device import check_device

    device = check_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return device, gen, dtype or torch.float32


def _sphere_points(gen, n, object_radius, center, dtype, device):
    """``n`` points uniform in a ball of ``object_radius`` about ``center``,
    and their unit directions."""
    import torch

    direction = torch.randn((n, 3), generator=gen, dtype=dtype, device=device)
    direction = direction / torch.clamp(
        torch.linalg.norm(direction, dim=1, keepdim=True), min=1e-9)
    radii = object_radius * torch.pow(
        torch.rand((n, 1), generator=gen, dtype=dtype, device=device),
        1.0 / 3.0)
    c = torch.tensor(center, dtype=dtype, device=device)
    return c + direction * radii, direction


def _next_pow2(n: int) -> int:
    return 1 << int(np.ceil(np.log2(max(n, 1))))


def _rig_tables(n_arc, n_ring, rho, object_radius, focal, image_size, seed):
    """The turntable rig's host tables (as :func:`make_hemisphere_rig`
    builds them) and its cells' slot rules: (data, outer, inner, intr)."""
    d = make_hemisphere_rig(
        n_arc=n_arc, n_ring=n_ring, n_points=8, rho=rho,
        object_radius=object_radius, focal=focal, image_size=image_size,
        seed=seed).data
    arc = np.repeat(np.arange(n_arc), n_ring)
    ring = np.tile(np.arange(n_ring), n_arc)
    ring_rec = np.where(ring == 0, 0, ring + n_arc - 1)
    identity = d.n_extrinsics
    outer = np.where(ring == 0, arc, np.where(arc == 0, ring_rec, arc))
    inner = np.where((ring == 0) | (arc == 0), identity, ring_rec)
    return d, outer, inner, arc


def _params_of(ext_rot, ext_trans, center, focal, dist, n_points, dtype,
               device):
    """BAParams with zero points and the camera tables, each extrinsic
    table with its identity row appended."""
    import torch

    from deeparc_tpu_torch.scene import BAParams

    f = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)
    pad = np.zeros((1, 3))
    return BAParams(
        points=torch.zeros((n_points, 3), dtype=dtype, device=device),
        ext_rot=f(np.concatenate([ext_rot, pad])),
        ext_trans=f(np.concatenate([ext_trans, pad])),
        center=f(center), focal=f(focal), dist=f(dist))


def _cell_table(outer, inner, intr, focal_shared, dist_m1, dist_m2, R_rows,
                C, dtype, device):
    """The tile layout's CellTable of cells (outer, inner, intr), with its
    flat camera columns and the maps of its sums (``cell_maps``)."""
    import torch

    from deeparc_tpu_torch.solver.tiles import CellTable, cell_maps

    six = np.arange(6)
    cols = np.concatenate(
        [outer[:, None] * 6 + six, inner[:, None] * 6 + six,
         6 * R_rows + intr[:, None] * 6 + six], axis=1).astype(np.int32)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    f = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)
    cols_t = i32(cols)
    return CellTable(slot_outer=i32(outer), slot_inner=i32(inner),
                     slot_intr=i32(intr), focal_shared=f(focal_shared),
                     dist_m1=f(dist_m1), dist_m2=f(dist_m2), cols=cols_t,
                     maps=cell_maps(cols_t, C))


def _project_slots(gt, packed, cell, mask):
    """Predicted pixels (N, W, 2) of the points ``gt`` in the slots' cells
    (global ids into ``packed``), through the tile engine's chunk path with
    xy = 0; masked slots give 0."""
    import torch

    from deeparc_tpu_torch.solver.tiles import (
        _project_chunk,
        _row_pieces,
        _unpack,
    )

    N, W = cell.shape
    pred = torch.empty((N, W, 2), dtype=gt.dtype, device=gt.device)
    for r0, r1 in _row_pieces(N, W):
        m = mask[r0:r1]
        zeros = torch.zeros_like(m)
        pred[r0:r1] = _project_chunk(gt[r0:r1],
                                     _unpack(packed[cell[r0:r1].long()]),
                                     zeros, zeros, m)["r"]
    return pred


def _observe(gen, pred, mask, pixel_noise):
    """Observed pixel planes (xy0, xy1): the predictions plus Gaussian
    pixel noise, 0 on masked slots."""
    import torch

    noise = torch.randn(pred.shape, generator=gen, dtype=pred.dtype,
                        device=pred.device)
    xy = (pred + pixel_noise * noise) * mask[..., None]
    return xy[..., 0].contiguous(), xy[..., 1].contiguous()


def _perturbed(gen, gt, point_noise):
    import torch

    return gt + point_noise * torch.randn(gt.shape, generator=gen,
                                          dtype=gt.dtype, device=gt.device)


def _distinct_ids(gen, n_rows, n_live, width, hi, device):
    """(n_rows, width) int64 ids, the first ``n_live`` of each row distinct
    in [0, hi): sorted draws from [0, hi - n_live] plus their rank, so
    strictly increasing (a shift of duplicates modulo ``hi`` could wrap
    onto an id the row already holds). The slots after ``n_live`` hold
    0."""
    import torch

    if n_live > hi:
        raise ValueError(f"{n_live} distinct ids do not fit in [0, {hi})")
    draw = torch.randint(0, hi - n_live + 1, (n_rows, n_live), generator=gen,
                         device=device)
    ids = torch.zeros((n_rows, width), dtype=torch.int64, device=device)
    ids[:, :n_live] = (torch.sort(draw, dim=1).values
                       + torch.arange(n_live, device=device))
    return ids


def _bucket(cell, xy0, xy1, mask, loc, V):
    """A TileBucket with its slot bins and row-piece maps (``with_bins``),
    as the solvers take it."""
    import torch

    from deeparc_tpu_torch.solver.tiles import TileBucket, with_bins

    return with_bins(TileBucket(cell=cell.to(torch.int32), xy0=xy0, xy1=xy1,
                                mask=mask, loc=loc), V)


def make_grid_rig_device(
    n_arc: int = 8,
    n_ring: int = 24,
    n_points: int = 400_000,
    rho: float = 2.0,
    object_radius: float = 0.4,
    focal: float = 1000.0,
    image_size: tuple = (1600, 1200),
    pixel_noise: float = 1.0,
    point_noise: float = 0.02,
    visibility: float = None,
    occlusion_rings: int | None = None,
    seed: int = 0,
    dtype=None,
    device="cuda",
):
    """The turntable rig of :func:`make_hemisphere_rig` built directly in
    the dense-grid layout on ``device``: only the camera tables cross from
    the host; the (N, T) planes are drawn and projected there, through the
    port's own ``grid_residuals`` with xy = 0 and mask = 1.

    ``occlusion_rings`` models self-occlusion: a point is seen only while
    the turntable faces it toward the camera meridian, from a contiguous
    cyclic window of that many of the ``n_ring`` steps (all arcs inside
    the window, subject to the image bounds and ``visibility``). ``None``
    keeps visibility uniform over all cells. ``visibility`` keeps each
    remaining observation with that probability, so the mean track is
    about ``visibility * occlusion_rings * n_arc``.

    Returns (params: BAParams, grid: GridIndex, gt_points (N, 3))."""
    import dataclasses as _dc

    import torch

    from deeparc_tpu_torch.solver.rig_grid import (
        GridIndex,
        grid_residuals,
        slot_params,
    )

    device, gen, dtype = _device_setup(device, seed, dtype)
    d, outer, inner, intr = _rig_tables(n_arc, n_ring, rho, object_radius,
                                        focal, image_size, seed)
    params_gt = _params_of(d.ext_rot, d.ext_trans, d.center, d.focal, d.dist,
                           n_points, dtype, device)
    T = n_arc * n_ring
    identity = d.n_extrinsics

    def onehot(ids, n):
        out = np.zeros((T, n))
        out[np.arange(T), ids] = 1.0
        return torch.tensor(out, dtype=dtype, device=device)

    f = lambda a: torch.tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    plane = lambda: torch.empty((n_points, T), dtype=dtype, device=device)
    grid = GridIndex(
        xy0=plane(), xy1=plane(), mask=plane(),
        point_mask=torch.ones((n_points,), dtype=dtype, device=device),
        slot_outer=i32(outer), slot_inner=i32(inner), slot_intr=i32(intr),
        onehot_outer=onehot(outer, identity + 1),
        onehot_inner=onehot(inner, identity + 1),
        onehot_intr=onehot(intr, d.n_intrinsics),
        focal_shared=f((d.focal_size == 1)[intr]),
        dist_m1=f((d.dist_size >= 1)[intr]),
        dist_m2=f((d.dist_size == 2)[intr]))

    gt_points, direction = _sphere_points(gen, n_points, object_radius,
                                          (0.0, 0.0, rho), dtype, device)
    keep = (torch.rand((n_points, T), generator=gen, dtype=dtype,
                       device=device) < visibility
            if visibility is not None else None)
    sp = slot_params(params_gt, grid)
    w, h = image_size
    if occlusion_rings is not None:
        # the point's azimuth about the turntable's vertical axis; it is
        # seen while the ring rotation turns it within half the window of
        # facing the camera meridian
        alpha = torch.atan2(direction[:, 0], direction[:, 2])
        phis = (2.0 * np.pi / n_ring) * f(np.tile(np.arange(n_ring), n_arc))
        cos_half = float(np.cos(np.pi * occlusion_rings / n_ring))
    # the projection's (rows, T) temporaries bounded to ~2^22 values each
    step = max(1, (1 << 22) // T)
    for r0 in range(0, n_points, step):
        r1 = min(n_points, r0 + step)
        ones = torch.ones((r1 - r0, T), dtype=dtype, device=device)
        zeros = torch.zeros_like(ones)
        sub = _dc.replace(grid, xy0=zeros, xy1=zeros, mask=ones,
                          point_mask=grid.point_mask[r0:r1])
        pred = grid_residuals(gt_points[r0:r1], sp, sub)
        m = ((pred[..., 0] >= 0) & (pred[..., 0] < w)
             & (pred[..., 1] >= 0) & (pred[..., 1] < h))
        if occlusion_rings is not None:
            facing = torch.cos(alpha[r0:r1, None] + phis[None, :] - np.pi)
            m &= facing > cos_half
        if keep is not None:
            m &= keep[r0:r1]
        grid.mask[r0:r1] = m.to(dtype)
        grid.xy0[r0:r1] = pred[..., 0]
        grid.xy1[r0:r1] = pred[..., 1]
    del keep
    noise = torch.randn((n_points, T, 2), generator=gen, dtype=dtype,
                        device=device)
    grid.xy0.add_(pixel_noise * noise[..., 0]).mul_(grid.mask)
    grid.xy1.add_(pixel_noise * noise[..., 1]).mul_(grid.mask)
    del noise
    params = _dc.replace(params_gt,
                         points=_perturbed(gen, gt_points, point_noise))
    return params, grid, gt_points


def make_tile_rig_device(
    n_arc: int = 8,
    n_ring: int = 24,
    n_points: int = 400_000,
    track_length: int = 10,
    rho: float = 2.0,
    object_radius: float = 0.4,
    focal: float = 1000.0,
    image_size: tuple = (1600, 1200),
    pixel_noise: float = 1.0,
    point_noise: float = 0.02,
    seed: int = 0,
    chunk_obs: int = None,
    dtype=None,
    device="cuda",
):
    """The turntable rig of :func:`make_grid_rig_device` built directly in
    the TILE layout on ``device``: each point observes ``track_length``
    distinct random cells, laid out as one dense (N_pad, W) bucket with W
    = next_pow2(track_length) (every live slot first in its row), N_pad
    the points rounded up to whole chunks of rows (the rows past
    ``n_points`` are real points too). Visibility is uniform over all T
    cells, but T is small, so the bucket carries identity per-chunk local
    tables (local id == global id; each chunk's table the whole cell list,
    padded with cell 0 to a multiple of 8), which routes it through the
    fused ``tile_linearize_local`` and ``tile_sweep_local``.

    Returns (params_t: BAParams (rows == points), tiles: TileIndex,
    gt_points (N_pad, 3), cam_free (C,))."""
    import dataclasses as _dc

    import torch

    from deeparc_tpu_torch.solver.rig_grid import slot_params
    from deeparc_tpu_torch.solver.tiles import (
        CHUNK_OBS,
        TileIndex,
        pack_cells,
        rows_per_chunk,
    )

    device, gen, dtype = _device_setup(device, seed, dtype)
    chunk_obs = chunk_obs or CHUNK_OBS
    d, outer, inner, intr = _rig_tables(n_arc, n_ring, rho, object_radius,
                                        focal, image_size, seed)
    T = n_arc * n_ring
    if track_length > T:
        raise ValueError(f"track_length {track_length} > {T} cells")
    W = _next_pow2(track_length)
    rpc = rows_per_chunk(W, chunk_obs)
    N_pad = -(-n_points // rpc) * rpc
    params_gt = _params_of(d.ext_rot, d.ext_trans, d.center, d.focal, d.dist,
                           N_pad, dtype, device)
    R_rows = d.n_extrinsics + 1
    C = 6 * R_rows + 6 * d.n_intrinsics
    cells = _cell_table(outer, inner, intr, (d.focal_size == 1)[intr],
                        (d.dist_size >= 1)[intr], (d.dist_size == 2)[intr],
                        R_rows, C, dtype, device)
    cam_free = torch.ones((C,), dtype=dtype, device=device)
    packed = pack_cells(slot_params(params_gt, cells), cells, cam_free)

    gt_points, _ = _sphere_points(gen, N_pad, object_radius, (0.0, 0.0, rho),
                                  dtype, device)
    # each point sees track_length distinct random cells
    scores = torch.rand((N_pad, T), generator=gen, device=device)
    cell = torch.zeros((N_pad, W), dtype=torch.int64, device=device)
    cell[:, :track_length] = torch.topk(scores, track_length, dim=1).indices
    del scores
    mask = torch.zeros((N_pad, W), dtype=dtype, device=device)
    mask[:, :track_length] = 1.0
    pred = _project_slots(gt_points, packed, cell, mask)
    xy0, xy1 = _observe(gen, pred, mask, pixel_noise)
    del pred
    nch = N_pad // rpc
    ids = np.zeros(-(-T // 8) * 8, dtype=np.int32)
    ids[:T] = np.arange(T, dtype=np.int32)
    chunk_cells = torch.tensor(np.tile(ids, (nch, 1)), device=device)
    cell = cell.to(torch.int32)
    bucket = _bucket(cell, xy0, xy1, mask, (cell, chunk_cells), T)
    tiles = TileIndex(cells=cells, buckets=(bucket,),
                      row_of_point=torch.arange(N_pad, dtype=torch.int32,
                                                device=device))
    params = _dc.replace(params_gt,
                         points=_perturbed(gen, gt_points, point_noise))
    return params, tiles, gt_points, cam_free


def _bal_camera_tables(n_cameras, rho, focal, image_size, rng,
                       order_by_azimuth):
    """Host-side BAL camera tables: poses on a view sphere + intrinsics.

    Shared by the device-side BAL generators. ``order_by_azimuth`` sorts
    cameras along the sphere so consecutive ids are physically adjacent
    (windowed co-visibility is then geometric)."""
    ext_rot = np.zeros((n_cameras, 3))
    ext_trans = np.zeros((n_cameras, 3))
    dirs = rng.normal(size=(n_cameras, 3))
    dirs[:, 1] = np.clip(dirs[:, 1], -0.9, 0.9)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    if order_by_azimuth:
        dirs = dirs[np.argsort(np.arctan2(dirs[:, 2], dirs[:, 0]))]
    for c in range(n_cameras):
        R, t = _look_at(rho * dirs[c], np.zeros(3))
        ext_rot[c] = _rotmat_to_aa(R)
        ext_trans[c] = t
    cx, cy = image_size[0] / 2.0, image_size[1] / 2.0
    center = np.tile([cx, cy], (n_cameras, 1))
    focal_arr = np.zeros((n_cameras, 2))
    focal_arr[:, 0] = focal * (1.0 + 0.05 * rng.normal(size=n_cameras))
    dist_arr = np.zeros((n_cameras, 2))
    dist_arr[:, 0] = -0.02
    dist_arr[:, 1] = 0.005
    return ext_rot, ext_trans, center, focal_arr, dist_arr


def _bal_setup(n_cameras, rho, focal, image_size, rng, order_by_azimuth,
               n_points, dtype, device):
    """The BAL generators' camera side: (params with zero points, the
    CellTable of the n_cameras cells (one free camera each: outer = its
    extrinsic, inner = the identity row, its own intrinsic), cam_free,
    the packed cell table)."""
    import torch

    from deeparc_tpu_torch.solver.rig_grid import slot_params
    from deeparc_tpu_torch.solver.tiles import pack_cells

    ext_rot, ext_trans, center, focal_arr, dist_arr = _bal_camera_tables(
        n_cameras, rho, focal, image_size, rng, order_by_azimuth)
    params = _params_of(ext_rot, ext_trans, center, focal_arr, dist_arr,
                        n_points, dtype, device)
    R_rows = n_cameras + 1
    C = 6 * R_rows + 6 * n_cameras
    cam_ids = np.arange(n_cameras)
    ones = np.ones(n_cameras)
    cells = _cell_table(cam_ids, np.full(n_cameras, n_cameras), cam_ids,
                        ones, ones, ones, R_rows, C, dtype, device)
    cam_free = torch.ones((C,), dtype=dtype, device=device)
    packed = pack_cells(slot_params(params, cells), cells, cam_free)
    return params, cells, cam_free, packed


def _window_starts(n_chunks, n_cameras, win):
    """First camera of each chunk's sliding window of ``win`` cameras."""
    return (np.arange(n_chunks) * max(n_cameras - win, 0)
            // max(n_chunks - 1, 1)).astype(np.int32)


def make_bal_tile_device(
    n_cameras: int = 2000,
    n_points: int = 1_000_000,
    track_length: int = 8,
    rho: float = 3.0,
    object_radius: float = 1.0,
    focal: float = 800.0,
    image_size: tuple = (1024, 1024),
    pixel_noise: float = 1.0,
    point_noise: float = 0.02,
    seed: int = 0,
    chunk_obs: int = None,
    dtype=None,
    window: int | None = 128,
    device="cuda",
):
    """A BAL-style (non-shared) problem built directly in the TILE layout
    on ``device``: ``n_cameras`` free cameras on a view sphere (one
    intrinsic and one extrinsic each; cells == cameras), every point
    observing ``track_length`` distinct cameras, as one dense (N_pad, W)
    bucket with W = next_pow2(track_length). Only the (C, .) camera tables
    cross from the host.

    ``window`` (default 128) models BAL co-visibility locality: cameras
    are ordered by azimuth and each chunk of rows draws its tracks from
    one sliding window of ``window`` consecutive cameras, so the bucket
    carries exact per-chunk local tables (``TileBucket.loc``) by
    construction. ``window=None`` draws tracks uniformly over all cameras
    (no locality; the global tables, the ``tile_sweep`` path).

    A row's camera ids are drawn as sorted values from [0, hi -
    track_length] plus their rank (hi the window or the camera count), so
    every row's live ids are distinct. (The reference's duplicate shift,
    ``(sort + cumsum(dup)) % hi``, can wrap onto an id the row already
    holds.) Masked slots hold local id 0.

    Returns (params_t, tiles, gt_points (N_pad, 3), cam_free (C,))."""
    import dataclasses as _dc

    import torch

    from deeparc_tpu_torch.solver.tiles import (
        CHUNK_OBS,
        TileIndex,
        rows_per_chunk,
    )

    device, gen, dtype = _device_setup(device, seed, dtype)
    chunk_obs = chunk_obs or CHUNK_OBS
    rng = np.random.default_rng(seed)
    if window is not None:
        window = min(window, n_cameras)
    W = _next_pow2(track_length)
    rpc = rows_per_chunk(W, chunk_obs)
    N_pad = -(-n_points // rpc) * rpc
    params_gt, cells, cam_free, packed = _bal_setup(
        n_cameras, rho, focal, image_size, rng, window is not None, N_pad,
        dtype, device)
    nch = N_pad // rpc

    gt_points, _ = _sphere_points(gen, N_pad, object_radius, (0.0, 0.0, 0.0),
                                  dtype, device)
    hi = window if window is not None else n_cameras
    local = _distinct_ids(gen, N_pad, track_length, W, hi, device)
    mask = torch.zeros((N_pad, W), dtype=dtype, device=device)
    mask[:, :track_length] = 1.0
    if window is not None:
        starts = _window_starts(nch, n_cameras, window)
        chunk_cells = torch.tensor(
            starts[:, None] + np.arange(window, dtype=np.int32)[None, :],
            device=device)
        row_start = torch.repeat_interleave(
            torch.tensor(starts, dtype=torch.int64, device=device), rpc)
        cell = local + row_start[:, None]
        loc = (local.to(torch.int32), chunk_cells)
    else:
        cell, loc = local, ()
    pred = _project_slots(gt_points, packed, cell, mask)
    xy0, xy1 = _observe(gen, pred, mask, pixel_noise)
    del pred
    bucket = _bucket(cell, xy0, xy1, mask, loc, n_cameras)
    tiles = TileIndex(cells=cells, buckets=(bucket,),
                      row_of_point=torch.arange(N_pad, dtype=torch.int32,
                                                device=device))
    params = _dc.replace(params_gt,
                         points=_perturbed(gen, gt_points, point_noise))
    return params, tiles, gt_points, cam_free


def make_bal_heavytail_device(
    n_cameras: int = 2000,
    n_points: int = 1_000_000,
    mean_track: float = 8.0,
    sigma: float = 0.8,
    max_track: int = 512,
    rho: float = 3.0,
    object_radius: float = 1.0,
    focal: float = 800.0,
    image_size: tuple = (1024, 1024),
    pixel_noise: float = 1.0,
    point_noise: float = 0.02,
    seed: int = 0,
    chunk_obs: int = None,
    dtype=None,
    window: int = 128,
    device="cuda",
):
    """A BAL problem with a HEAVY-TAILED track distribution, built in the
    tile layout on ``device``: per-point track lengths from a clipped
    log-normal with mean ``mean_track`` and log-``sigma`` (drawn on the
    host with ``np.random.default_rng(seed)``, as the reference draws
    them), the points laid out in buckets of widths W =
    next_pow2(track) >= 4, as ``tiles_from_scene`` builds them from real
    files, so one solve runs the kernels on the narrow buckets and the
    torch paths on the wide ones.

    Tracks up to ``window`` cameras draw from a sliding window of
    ``window`` consecutive ids (chunk-exact local tables); wider ones from
    a window of 2W (long tracks are seen from everywhere), and a bucket
    whose window spans every camera carries no local tables. A row's W
    ids are sorted draws from [0, win - W] plus their rank: distinct.

    Returns (params_t, tiles, gt_points (rows, 3), cam_free (C,)); the
    rows are the buckets' padded rows in order, ``tiles.row_of_point``
    maps each of the ``n_points`` points to its row."""
    import dataclasses as _dc

    import torch

    from deeparc_tpu_torch.solver.tiles import (
        CHUNK_OBS,
        TileIndex,
        rows_per_chunk,
    )

    device, gen, dtype = _device_setup(device, seed, dtype)
    chunk_obs = chunk_obs or CHUNK_OBS
    rng = np.random.default_rng(seed)
    window = min(window, n_cameras)
    params_gt, cells, cam_free, packed = _bal_setup(
        n_cameras, rho, focal, image_size, rng, True, 1, dtype, device)

    # clipped log-normal track lengths with the requested mean
    mu = np.log(mean_track) - 0.5 * sigma * sigma
    track = np.clip(
        np.rint(rng.lognormal(mu, sigma, size=n_points)).astype(np.int64),
        2, min(max_track, n_cameras))
    width = (1 << np.ceil(np.log2(track)).astype(np.int64)).clip(4)

    row_of_point = np.zeros(n_points, np.int64)
    gt_parts, buckets = [], []
    offset = 0
    for W in sorted(int(w) for w in np.unique(width)):
        members = np.nonzero(width == W)[0]
        Nb = members.size
        rpc = rows_per_chunk(W, chunk_obs)
        Nb_pad = -(-Nb // rpc) * rpc
        n_ch = Nb_pad // rpc
        win = window if W <= window else min(2 * W, n_cameras)
        tracks_b = np.zeros(Nb_pad, np.int64)
        tracks_b[:Nb] = track[members]

        gt, _ = _sphere_points(gen, Nb_pad, object_radius, (0.0, 0.0, 0.0),
                               dtype, device)
        # W distinct window-local ids a row (when the window holds W; a
        # wider bucket than the cameras keeps its live slots distinct)
        n_ids = min(W, win)
        local = _distinct_ids(gen, Nb_pad, n_ids, W, win, device)
        iota = torch.arange(W, device=device)
        mask = (iota[None, :] < torch.tensor(tracks_b, device=device)[:, None]
                ).to(dtype)
        starts = _window_starts(n_ch, n_cameras, win)
        chunk_cells = starts[:, None] + np.arange(win, dtype=np.int32)[None, :]
        row_start = torch.repeat_interleave(
            torch.tensor(starts, dtype=torch.int64, device=device), rpc)
        cell = local + row_start[:, None]
        pred = _project_slots(gt, packed, cell, mask)
        xy0, xy1 = _observe(gen, pred, mask, pixel_noise)
        del pred
        loc = ((local.to(torch.int32),
                torch.tensor(chunk_cells, device=device))
               if win < n_cameras else ())
        buckets.append(_bucket(cell, xy0, xy1, mask, loc, n_cameras))
        gt_parts.append(gt)
        row_of_point[members] = offset + np.arange(Nb)
        offset += Nb_pad

    tiles = TileIndex(cells=cells, buckets=tuple(buckets),
                      row_of_point=torch.tensor(row_of_point.astype(np.int32),
                                                device=device))
    gt_points = torch.cat(gt_parts)
    params = _dc.replace(params_gt,
                         points=_perturbed(gen, gt_points, point_noise))
    return params, tiles, gt_points, cam_free

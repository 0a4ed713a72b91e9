"""``.deeparc`` file format: parser and writer (flat numpy arrays).

Implements the implicit spec reverse-engineered from the reference parser and
writer (SURVEY.md section 2.3; ``src/DeepArcManager.cc:26-74`` read,
``:426-499`` write). ASCII, whitespace-delimited:

  1. header: ``version`` then ``n_obs n_intrinsic n_arc n_ring n_point3d``
     (``DeepArcManager.cc:36-39``). ``share_extrinsic := n_ring != 0``
     (``:40``); stored extrinsic records = ``n_arc + n_ring - 1`` if shared
     else ``n_arc`` (``:43-44``): arc 0 and ring 0 share record 0, ring r > 0
     lives at record ``r + n_arc - 1`` (``:166-171``).
  2. n_obs observations: ``pos_arc pos_ring point3d_id x y``
     (``:76-91``). In non-shared mode the first two columns mean
     ``intrinsic_id extrinsic_id`` (``ParameterBlock.hh:52-55``).
  3. n_intrinsic intrinsics: ``cx cy n_focal f... n_dist d...`` (``:93-122``).
  4. extrinsics: ``tx ty tz n_rot r...`` with n_rot in {3, 4, 9}; quaternion /
     column-major rotation matrix converted to angle-axis on load
     (``:124-151``); the writer always emits angle-axis (``:476-487``).
  5. n_point3d points: ``x y z r g b`` (``:153-164``).

Parity quirks, handled explicitly instead of silently:
  * The reference truncates fractional principal points to int on load
    (``src/Camera/Intrinsic.hh:24``, flagged in SURVEY.md section 2.1). We
    keep full precision by default; ``parity_truncate_center=True`` reproduces
    the truncation.
  * Point colors are read as double but stored as int (truncated) by
    ``Point3d``'s ctor (``src/Point/Point3d.hh:7``); we truncate the same way.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DeepArcData:
    """Host-side (numpy) contents of a ``.deeparc`` scene.

    The flat-array replacement for the reference's pointer graph
    (DeepArcManager / ParameterBlock / Point3d). ``ext_rot``/``ext_trans`` use
    the on-file record layout: row 0 = shared arc-0/ring-0 slot, rows
    [1, n_arc) = arcs, ring r > 0 at row ``r + n_arc - 1`` (shared mode).
    """

    version: float
    share_extrinsic: bool
    arc_size: int            # header n_arc (non-shared: number of cameras)
    ring_size: int           # header n_ring (0 means non-shared)
    # observations (M,)
    obs_arc: np.ndarray      # int32; pos_arc / intrinsic_id column
    obs_ring: np.ndarray     # int32; pos_ring / extrinsic_id column
    obs_point: np.ndarray    # int32
    obs_xy: np.ndarray       # float64 (M, 2)
    # intrinsics (K, ...)
    center: np.ndarray       # (K, 2)
    focal: np.ndarray        # (K, 2), zero-padded
    focal_size: np.ndarray   # int32 (K,), 1 or 2
    dist: np.ndarray         # (K, 2), zero-padded
    dist_size: np.ndarray    # int32 (K,), 0..2
    # extrinsics (E, 3) in canonical angle-axis
    ext_rot: np.ndarray
    ext_trans: np.ndarray
    # points (N, ...)
    points: np.ndarray       # (N, 3)
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

    def ring_record_index(self, ring_pos: np.ndarray) -> np.ndarray:
        """Extrinsic record index for a ring position (DeepArcManager.cc:166-171)."""
        ring_pos = np.asarray(ring_pos)
        return np.where(ring_pos == 0, 0, ring_pos + self.arc_size - 1)


def _np_quaternion_to_angle_axis(q: np.ndarray) -> np.ndarray:
    """Numpy twin of geometry.rotation.quaternion_to_angle_axis (load path only)."""
    w, xyz = q[0], np.asarray(q[1:])
    sin_half2 = float(np.dot(xyz, xyz))
    if sin_half2 < 1e-24:
        return 2.0 * xyz
    sin_half = np.sqrt(sin_half2)
    if w < 0:
        two_theta = 2.0 * np.arctan2(-sin_half, -w)
    else:
        two_theta = 2.0 * np.arctan2(sin_half, w)
    return xyz * (two_theta / sin_half)


def _np_matrix_to_angle_axis(R_colmajor: np.ndarray) -> np.ndarray:
    """Column-major 9-vector -> angle-axis (Ceres RotationMatrixToAngleAxis
    semantics: raw pointers are column-major; ``DeepArcManager.cc:141-142``)."""
    R = np.asarray(R_colmajor, dtype=np.float64).reshape(3, 3, order="F")
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
    return _np_quaternion_to_angle_axis(q)


def read_deeparc(path: str, parity_truncate_center: bool = False) -> DeepArcData:
    """Parse a ``.deeparc`` file (reference ``DeepArcManager::read``, cc:26-74)."""
    with open(path, "r") as f:
        tokens = f.read().split()
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos:pos + n]
        if len(out) != n:
            raise ValueError(f"{path}: truncated file at token {pos}")
        pos += n
        return out

    version = float(take(1)[0])
    n_obs, n_intr, n_arc, n_ring, n_pts = (int(t) for t in take(5))
    share = n_ring != 0
    n_ext = n_arc + n_ring - 1 if share else n_arc

    obs = np.array(take(5 * n_obs), dtype=np.float64).reshape(n_obs, 5)
    obs_arc = obs[:, 0].astype(np.int32)
    obs_ring = obs[:, 1].astype(np.int32)
    obs_point = obs[:, 2].astype(np.int32)
    obs_xy = np.ascontiguousarray(obs[:, 3:5])

    center = np.zeros((n_intr, 2))
    focal = np.zeros((n_intr, 2))
    focal_size = np.zeros(n_intr, dtype=np.int32)
    dist = np.zeros((n_intr, 2))
    dist_size = np.zeros(n_intr, dtype=np.int32)
    for i in range(n_intr):
        cx, cy = (float(t) for t in take(2))
        if parity_truncate_center:
            # Reproduce the int-truncation quirk (src/Camera/Intrinsic.hh:24).
            cx, cy = float(int(cx)), float(int(cy))
        center[i] = (cx, cy)
        nf = int(take(1)[0])
        focal_size[i] = nf
        for j in range(nf):
            focal[i, j] = float(take(1)[0])
        nd = int(take(1)[0])
        dist_size[i] = nd
        for j in range(nd):
            dist[i, j] = float(take(1)[0])

    ext_rot = np.zeros((n_ext, 3))
    ext_trans = np.zeros((n_ext, 3))
    for i in range(n_ext):
        ext_trans[i] = [float(t) for t in take(3)]
        n_rot = int(take(1)[0])
        rot = np.array([float(t) for t in take(n_rot)])
        if n_rot == 9:
            ext_rot[i] = _np_matrix_to_angle_axis(rot)
        elif n_rot == 4:
            ext_rot[i] = _np_quaternion_to_angle_axis(rot)
        elif n_rot == 3:
            ext_rot[i] = rot
        else:
            raise ValueError(f"{path}: unsupported rotation arity {n_rot}")

    pts = np.array(take(6 * n_pts), dtype=np.float64).reshape(n_pts, 6)
    points = np.ascontiguousarray(pts[:, :3])
    colors = pts[:, 3:6].astype(np.int32)  # double -> int truncation, as reference

    if pos != len(tokens):
        raise ValueError(f"{path}: {len(tokens) - pos} trailing tokens")

    return DeepArcData(
        version=version, share_extrinsic=share, arc_size=n_arc, ring_size=n_ring,
        obs_arc=obs_arc, obs_ring=obs_ring, obs_point=obs_point, obs_xy=obs_xy,
        center=center, focal=focal, focal_size=focal_size,
        dist=dist, dist_size=dist_size,
        ext_rot=ext_rot, ext_trans=ext_trans, points=points, colors=colors,
    )


def write_deeparc(data: DeepArcData, path: str) -> None:
    """Serialize to ``.deeparc`` (reference ``DeepArcManager::write``, cc:426-499).

    Matches the writer's fixed 6-decimal format (cc:428), version line
    ``0.010000`` (cc:433), always-angle-axis extrinsics (cc:483), and the
    shared-mode header ``arc_size ring_size`` vs non-shared
    ``n_cameras 0`` (cc:436-440). Points are assumed already compacted
    (the reference re-indexes survivors at cc:429-432; here compaction happens
    in the scene layer before writing).
    """
    f6 = lambda v: f"{v:.6f}"
    lines = ["0.010000"]
    if data.share_extrinsic:
        hdr_arc, hdr_ring = data.arc_size, data.ring_size
    else:
        hdr_arc, hdr_ring = data.n_extrinsics, 0
    lines.append(
        f"{data.n_obs} {data.n_intrinsics} {hdr_arc} {hdr_ring} {data.n_points}"
    )
    for a, r, p, (x, y) in zip(
        data.obs_arc, data.obs_ring, data.obs_point, data.obs_xy
    ):
        lines.append(f"{a} {r} {p} {f6(x)} {f6(y)}")
    for i in range(data.n_intrinsics):
        parts = [f6(data.center[i, 0]), f6(data.center[i, 1]),
                 str(int(data.focal_size[i]))]
        parts += [f6(data.focal[i, j]) for j in range(int(data.focal_size[i]))]
        parts.append(str(int(data.dist_size[i])))
        parts += [f6(data.dist[i, j]) for j in range(int(data.dist_size[i]))]
        lines.append(" ".join(parts))
    for i in range(data.n_extrinsics):
        t, r = data.ext_trans[i], data.ext_rot[i]
        lines.append(
            f"{f6(t[0])} {f6(t[1])} {f6(t[2])} 3 {f6(r[0])} {f6(r[1])} {f6(r[2])}"
        )
    for i in range(data.n_points):
        p, c = data.points[i], data.colors[i]
        lines.append(
            f"{f6(p[0])} {f6(p[1])} {f6(p[2])} {int(c[0])} {int(c[1])} {int(c[2])}"
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")

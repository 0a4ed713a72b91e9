"""BAL (Bundle Adjustment in the Large) problem reader.

The reference has no BAL support; this exists for the large-scale distributed
configs in BASELINE.json (config 5: venice-scale problems sharded over a
mesh). BAL format: header ``n_cameras n_points n_obs``; observations
``cam_idx point_idx x y``; then 9 doubles per camera (angle-axis R, t, f, k1,
k2); then 3 doubles per point.

BAL's projection negates the perspective divide (``p = -P / P.z``) where the
deeparc model does not (``src/snavely_reprojection_error.hh:49-50``; see the
quirk note in SURVEY.md section 2.1). Rather than branch the hot model, the
loader folds the sign into the focal length: with center = 0 and the radial
term even in (xp, yp),  f * d * (-xp) == (-f) * d * xp, so storing
``focal = -f`` makes the uniform deeparc model evaluate BAL residuals
exactly.
"""

from __future__ import annotations

import gzip

import numpy as np

from deeparc_tpu_torch.io.deeparc_format import DeepArcData


def read_bal(path: str) -> DeepArcData:
    """Read a BAL problem into the non-shared-extrinsic scene layout.

    Cameras map to one intrinsic + one extrinsic each (non-shared mode,
    ``ParameterBlock.hh:52-55`` column semantics: obs_arc = intrinsic id,
    obs_ring = extrinsic id).
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tokens = f.read().split()
    it = iter(tokens)
    n_cam, n_pts, n_obs = int(next(it)), int(next(it)), int(next(it))

    obs = np.array([next(it) for _ in range(4 * n_obs)], dtype=np.float64)
    obs = obs.reshape(n_obs, 4)
    obs_cam = obs[:, 0].astype(np.int32)
    obs_point = obs[:, 1].astype(np.int32)
    obs_xy = np.ascontiguousarray(obs[:, 2:4])

    cam = np.array([next(it) for _ in range(9 * n_cam)], dtype=np.float64)
    cam = cam.reshape(n_cam, 9)
    pts = np.array([next(it) for _ in range(3 * n_pts)], dtype=np.float64)
    pts = pts.reshape(n_pts, 3)

    focal = np.zeros((n_cam, 2))
    focal[:, 0] = -cam[:, 6]  # sign fold: BAL projects p = -P/P.z
    dist = cam[:, 7:9].copy()
    return DeepArcData(
        version=0.01, share_extrinsic=False, arc_size=n_cam, ring_size=0,
        obs_arc=obs_cam, obs_ring=obs_cam, obs_point=obs_point, obs_xy=obs_xy,
        center=np.zeros((n_cam, 2)), focal=focal,
        focal_size=np.ones(n_cam, dtype=np.int32),
        dist=dist, dist_size=np.full(n_cam, 2, dtype=np.int32),
        ext_rot=np.ascontiguousarray(cam[:, 0:3]),
        ext_trans=np.ascontiguousarray(cam[:, 3:6]),
        points=pts,
        colors=np.full((n_pts, 3), 255, dtype=np.int32),
    )

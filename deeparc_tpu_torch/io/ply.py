"""ASCII PLY export of camera centers + colored points.

Equivalent of ``DeepArcManager::writePly`` (``src/DeepArcManager.cc:266-328``):
camera vertices first — green for single-extrinsic cameras (base arc / base
ring), magenta for composed arc x ring cameras (cc:287-306) — then the point
cloud with its RGB colors (cc:316-326).
"""

from __future__ import annotations

import numpy as np


_GREEN = (0, 255, 0)
_MAGENTA = (255, 0, 255)


def write_ply(
    path: str,
    points: np.ndarray,
    colors: np.ndarray,
    camera_centers: np.ndarray | None = None,
    camera_is_composed: np.ndarray | None = None,
) -> None:
    """Write points (N, 3) + colors (N, 3) and optional camera centers (C, 3).

    ``camera_is_composed`` (C,) bool selects magenta (True) vs green, matching
    the reference's coloring of composed rig cameras (cc:291-304).
    """
    points = np.asarray(points)
    colors = np.asarray(colors).astype(np.int64)
    if camera_centers is None:
        camera_centers = np.zeros((0, 3))
    camera_centers = np.asarray(camera_centers)
    n_cam = camera_centers.shape[0]
    if camera_is_composed is None:
        camera_is_composed = np.zeros(n_cam, dtype=bool)

    lines = [
        "ply",
        "format ascii 1.0",
        f"element vertex {points.shape[0] + n_cam}",
        "property float x",
        "property float y",
        "property float z",
        "property uchar red",
        "property uchar green",
        "property uchar blue",
        "end_header",
    ]
    for i in range(n_cam):
        c = camera_centers[i]
        rgb = _MAGENTA if camera_is_composed[i] else _GREEN
        lines.append(f"{c[0]:g} {c[1]:g} {c[2]:g} {rgb[0]} {rgb[1]} {rgb[2]}")
    for p, c in zip(points, colors):
        lines.append(f"{p[0]:g} {p[1]:g} {p[2]:g} {c[0]} {c[1]} {c[2]}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")

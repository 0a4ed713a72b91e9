"""The numbers that decide ``correct``: gaps between what the timed path
returned and the plain reference's answer from the same arrays.

  points_gap    max over points of the largest coordinate gap, over the
                median distance the reference moved a point
  cameras_gap   max over the kinds of camera parameter (each column of
                the extrinsic and of the intrinsic rows) of the largest
                gap, over the median distance the reference moved that
                kind's free entries
  cost_gap      |cost - reference cost| / reference cost

The pipeline adds the hemisphere's largest relative gap and the
observations that one side keeps and the other drops (exact). A shape
that differs gives an infinite gap.
"""

from __future__ import annotations

import sys

import numpy as np

# a gap that cannot be measured (shapes differ, a value not finite): the
# largest float, so the result line stays valid JSON and the limit fails
INF = sys.float_info.max


def _median_move(new, start, free=None):
    move = np.abs(new - start)
    if free is not None:
        move = move[free]
    move = move[move > 0]
    return float(np.median(move)) if move.size else 1.0


def _cameras_gap(ans, ref, start) -> float:
    """The largest gap of a kind of camera parameter (a column of the
    extrinsic rows [rotation, translation] or of the intrinsic rows
    [center, focal, k1, k2]) over the median distance the reference moved
    that kind's free entries; a kind with none free, over the median move
    of all free parameters."""
    cols = lambda v: v.reshape(-1, 6)
    a, r, s = cols(ans), cols(ref), cols(start["cameras"])
    free = cols(start["cameras_free"])
    pooled = _median_move(ref, start["cameras"], start["cameras_free"])
    n = start["ext_rows"]
    worst = 0.0
    for rows in (slice(0, n), slice(n, None)):
        for j in range(6):
            gap = np.abs(a[rows, j] - r[rows, j])
            if not gap.size:
                continue
            move = np.abs(r[rows, j] - s[rows, j])[free[rows, j]]
            move = move[move > 0]
            scale = float(np.median(move)) if move.size else pooled
            worst = max(worst, float(np.max(gap)) / scale)
    return worst


def solve_gaps(ans: dict, ref: dict, start: dict) -> dict:
    """Gaps of one solve's answer {points, cameras, cost} against the
    reference's; ``start`` holds the starting points and cameras, the free
    camera parameters and the number of extrinsic rows."""
    out = {}
    if ans["points"].shape != ref["points"].shape:
        out["points_gap"] = INF
    else:
        move = np.linalg.norm(ref["points"] - start["points"], axis=1)
        scale = float(np.median(move[move > 0])) if (move > 0).any() else 1.0
        out["points_gap"] = float(
            np.max(np.abs(ans["points"] - ref["points"]))) / scale
    if ans["cameras"].shape != ref["cameras"].shape:
        out["cameras_gap"] = INF
    else:
        out["cameras_gap"] = _cameras_gap(ans["cameras"], ref["cameras"],
                                          start)
    out["cost_gap"] = abs(ans["cost"] - ref["cost"]) / abs(ref["cost"])
    return {k: (v if np.isfinite(v) else INF) for k, v in out.items()}


def pipeline_gaps(ans: dict, ref: dict, start: dict) -> dict:
    """Gaps of one pipeline's answer: the solve's gaps over the surviving
    points, plus hemisphere and observation-set differences."""
    keys_a, keys_r = ans["obs_keys"], ref["obs_keys"]
    out = {"hemisphere_gap": float(np.max(np.abs(
        ans["hemisphere"] - ref["hemisphere"])) / np.max(np.abs(
            ref["hemisphere"]))),
        "obs_mismatch": float(np.setxor1d(keys_a, keys_r,
                                          assume_unique=True).size)}
    alive = ref["point_alive"]
    pts_start = start["points"][alive] if alive.size == start[
        "points"].shape[0] else start["points"]
    out.update(solve_gaps(
        ans, ref, dict(start, points=pts_start)))
    return {k: (v if np.isfinite(v) else INF) for k, v in out.items()}

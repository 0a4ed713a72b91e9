"""Scan the banded grid kernels' point tile (``block_np``) against the
monolithic pair on one rig.

    python -m deeparc_tpu_torch.scripts.profile_grid_band [--n-points N]
    python -m deeparc_tpu_torch.scripts.profile_grid_band --device cpu \\
        --n-points 3000                        # plain versions, small

The rig is ``make_grid_rig_device``'s occlusion flagship (8 x 24 cells,
400k points seen from a cyclic window of 6 rings, visibility 10/48, seed
0, float64) with the pipeline's full-BA free mask (intrinsics frozen, so
the banded linearize keeps the extrinsic columns of E only). First the
monolithic ``linearize_grid`` and ``cost_grid`` on the rig as it comes,
with the plane stack a solve builds once (``mono_stack``); then, for each
``block_np`` (256 and 512) with ``cost_block_np`` 1024, ``band_grid`` and
the banded pair on its layout: each row gives ``w_band`` /
``w_band_cost``, the width groups, the time (median of ``--reps`` CUDA-event
runs), the bytes the kernel must move (the counts of ``chip_smoke.py``
phase 3: its inputs and outputs, for the cost pass the mask planes, the
live xy sectors, the points and the bands' table rows), its bound
(``scripts.bound``, the larger of bytes over the memory rate and the live
slots' operations over the float64 peak) and the bound's share of the
time, which raises above ``scripts.SHARE_LIMIT``. The banded linearize
takes tiles of up to ``LIN_MAX_BLOCK_NP`` (256) points on the card: past
that its row holds the wrapper's refusal in place of a time; every other
error raises. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.scripts import (
    OPS_PER_SLOT,
    band_rows,
    bound,
    card_fields,
    check_share,
    cost_band_bytes,
    launch_counts,
    nbytes,
    time_ms,
)

FLAGSHIP_POINTS = 400_000
OCCLUSION_RINGS = 6
BLOCK_NPS = (256, 512)
COST_BLOCK_NP = 1024


def band_preps(grid, block_nps=BLOCK_NPS, cost_block_np=COST_BLOCK_NP):
    """Yield (block_np, ``band_grid``'s prep of ``grid`` at that tile,
    None where it declines), one prep at a time."""
    from deeparc_tpu_torch.solver.rig_band import band_grid

    for bn in block_nps:
        yield bn, band_grid(grid, block_np=bn, cost_block_np=cost_block_np)


def _row(fn, reps, dev, moved_in, live, name, label, may_refuse=False):
    """One kernel's row: its time, the bytes it moves (``moved_in`` read
    and its outputs written), its bound and the bound's share of the time
    (at most ``SHARE_LIMIT``: above it the count is wrong). With
    ``may_refuse`` (the banded linearize past ``LIN_MAX_BLOCK_NP``) the
    route's refusal of the tile stands in the row in place of a time; any
    other error raises."""
    try:
        out = fn()
    except ValueError as e:
        if not (may_refuse and "-point tiles" in str(e)):
            raise
        return {"refused": str(e)}
    moved = moved_in + nbytes(*(out if isinstance(out, tuple) else (out,)))
    del out
    ms = time_ms(fn, reps, dev)
    b_ms, b_by = bound(moved, live * OPS_PER_SLOT[name], "float64")
    return dict(ms=ms, gbytes=moved / 1e9, bound_ms=b_ms, bound_by=b_by,
                over_bound=ms / b_ms, share=check_share(label, b_ms / ms))


def run(device="cuda", n_points: int = FLAGSHIP_POINTS,
        occlusion_rings: int = OCCLUSION_RINGS, reps: int = 5,
        block_nps=BLOCK_NPS) -> dict:
    """The scan as a dict (the JSON line's fields)."""
    from deeparc_tpu_torch.kernels import (
        cost_grid,
        cost_grid_banded,
        linearize_grid,
        linearize_grid_banded,
        reset_launch_counts,
    )
    from deeparc_tpu_torch.kernels.rig_grid import LIN_MAX_BLOCK_NP
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scripts.profile_grid import grid_free, rig
    from deeparc_tpu_torch.solver.rig_grid import (
        mono_stack,
        slot_free,
        slot_params,
    )

    dev = check_device(device)
    params, grid = rig(n_points, occlusion_rings, dev)
    free = grid_free(params)
    N, T = grid.mask.shape
    live = int(grid.mask.sum())
    esz = params.points.element_size()
    tbl_bytes = T * 78 * esz
    reset_launch_counts()
    sp = slot_params(params, grid)
    cam_free = flatten_camera(free)
    tables = slot_free(cam_free, grid)
    pxm = mono_stack(grid, (256, COST_BLOCK_NP))
    pts, pf = params.points, free.points
    res = dict(
        card_fields(dev), n_points=n_points, occlusion_rings=occlusion_rings,
        t_cells=T, n_obs=live, dtype="float64", reps=reps,
        cost_block_np=COST_BLOCK_NP,
        stack_build_ms=time_ms(lambda: mono_stack(grid, (256, COST_BLOCK_NP)),
                               reps, dev))
    res["lin_full"] = _row(
        lambda: linearize_grid(pts, pf, sp, grid, *tables, block_np=256,
                               pxm=pxm), reps, dev,
        nbytes(pts, pf, grid.xy0, grid.xy1, grid.mask) + tbl_bytes, live,
        "linearize_grid", "lin_full")
    res["cost_full"] = _row(
        lambda: cost_grid(pts, sp, grid, block_np=COST_BLOCK_NP, pxm=pxm),
        reps, dev, cost_band_bytes(pts, (pxm,), T), live, "cost_grid",
        "cost_full")
    del pxm
    for bn, prep in band_preps(grid, block_nps):
        key = f"b{bn}"
        if prep is None:
            res[key] = {"declined": "band_grid found no locality"}
            continue
        g = prep.grid
        perm = prep.perm.long()
        p_b = dataclasses.replace(params, points=params.points[perm])
        pts_b, pf_b = p_b.points, pf[perm]
        sp_b = slot_params(p_b, g)
        tab_b = slot_free(cam_free, g)
        frozen = not bool(torch.any(tab_b[2] != 0))
        (bw_lin, bw_cost), _ = prep.widths
        row = dict(block_np=bn, w_band=prep.w_band,
                   w_band_cost=prep.w_band_cost,
                   lin_groups=prep.lin_groups, cost_groups=prep.cost_groups,
                   intr_frozen=frozen)
        row["lin"] = _row(
            lambda: linearize_grid_banded(
                pts_b, pf_b, sp_b, g, *tab_b, g.band[0], bw_lin,
                block_np=bn, intr_frozen=frozen, pxm=g.band[2]),
            reps, dev, nbytes(pts_b, pf_b, *g.band[2]) + tbl_bytes, live,
            "linearize_grid_banded", f"{key}.lin",
            may_refuse=bn > LIN_MAX_BLOCK_NP)
        row["cost"] = _row(
            lambda: cost_grid_banded(
                pts_b, sp_b, g, g.band[1], bw_cost, block_np=COST_BLOCK_NP,
                pxm=g.band[3]),
            reps, dev, cost_band_bytes(pts_b, g.band[3], band_rows(
                g.band[1], prep.cost_groups)), live, "cost_grid_banded",
            f"{key}.cost")
        res[key] = row
        del prep, g, pts_b, pf_b, sp_b, tab_b
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    res["launches"] = launch_counts()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--n-points", type=int, default=FLAGSHIP_POINTS,
                    help="points of the occlusion rig (cut only this)")
    ap.add_argument("--occlusion-rings", type=int, default=OCCLUSION_RINGS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.n_points, args.occlusion_rings,
                         args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

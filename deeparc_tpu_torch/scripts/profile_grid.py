"""Time the pieces of one grid-engine LM step, its Schur solve split into
the pieces the step runs.

    python -m deeparc_tpu_torch.scripts.profile_grid [--n-points N]
    python -m deeparc_tpu_torch.scripts.profile_grid --occlusion-rings 6
    python -m deeparc_tpu_torch.scripts.profile_grid --device cpu \\
        --n-points 1000                        # plain versions, small

The rig is ``make_grid_rig_device``'s (8 x 24 cells, seed 0, float64, the
main path's dtype): without ``--occlusion-rings`` 100k points at
visibility 10/192, uniform over the cells, which the monolithic kernels
take (with the plane stack a solve builds once); with it 400k points seen
from a cyclic window of that many rings at visibility 10/(8 rings), which
``band_grid`` preps for the banded kernels, as ``chip_smoke.py`` phase 4
runs the flagship. The free mask is the pipeline's full-BA one (gauge and
identity extrinsic rows and the intrinsics frozen).

Each time is the median of ``--reps`` runs (CUDA events on the card):
``slot_params``, the linearize (``assemble_grid_system``), the trial cost
(``grid_cost``), the Schur solve in the step's own pieces at the start
state's radius (``SolverOptions().initial_radius``) -- the LM diagonal,
augmented point blocks and ``inv3x3``; the reduced gradient and the
correction ``E2.T @ B^-1 E2`` in one pass over E (``schur_reduce``);
``S`` and ``masked_spd_solve``; the back-substitution ``e_dc`` and
``dp`` -- and the whole step (``make_grid_step``). Each piece is timed
alone, so the sum of the pieces and of the trial's ``slot_params`` stands
beside the step's Schur part (the step less the linearize and the trial
cost, the split of ``chip_smoke.py`` phase 3b; ``pieces_over_rest``):
the gap is what the step does besides (its decision scalars) and the
launches between. The kernel wrappers' launch counts over the run are in
the line. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import NamedTuple

import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.scripts import card_fields, launch_counts, time_ms

N_ARC, N_RING = 8, 24
UNIFORM_POINTS = 100_000
FLAGSHIP_POINTS = 400_000
# the pieces of the Schur solve, in the step's order
PIECES = ("lm_diagonal+aug+inv3x3", "schur_reduce", "S+masked_spd_solve",
          "e_dc+dp")


class Problem(NamedTuple):
    """A grid LM problem as the solve hands it to the step."""

    params: object
    grid: object
    free: object
    step_kw: dict        # make_grid_step's band / plane-stack arguments
    band: dict | None    # band_grid's widths and groups, None if monolithic


def grid_free(params):
    """The pipeline's full-BA free mask of a generated rig: the points and
    the extrinsics but record 0 (the gauge) and the identity row."""
    ext = torch.ones_like(params.ext_rot)
    ext[0] = ext[-1] = 0.0
    z = torch.zeros_like
    return dataclasses.replace(
        params, points=torch.ones_like(params.points), ext_rot=ext,
        ext_trans=ext.clone(), center=z(params.center),
        focal=z(params.focal), dist=z(params.dist))


def rig(n_points, occlusion_rings, device, seed=0, n_arc=N_ARC,
        n_ring=N_RING):
    """(params, grid) of the profiled rig (module docstring)."""
    from deeparc_tpu_torch.io import make_grid_rig_device

    vis = (10.0 / (n_arc * n_ring) if occlusion_rings is None
           else 10.0 / (n_arc * occlusion_rings))
    params, grid, _ = make_grid_rig_device(
        n_arc=n_arc, n_ring=n_ring, n_points=n_points, visibility=vis,
        occlusion_rings=occlusion_rings, pixel_noise=1.0, point_noise=0.02,
        seed=seed, dtype=torch.float64, device=device)
    return params, grid


def problem(n_points, occlusion_rings, device, seed=0, n_arc=N_ARC,
            n_ring=N_RING) -> Problem:
    """The rig laid out as ``solve_ba_grid`` lays it out: band-prepped and
    permuted with occlusion (raising if ``band_grid`` declines), with the
    monolithic plane stack otherwise."""
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.solver.rig_band import band_grid
    from deeparc_tpu_torch.solver.rig_grid import mono_stack

    params, grid = rig(n_points, occlusion_rings, device, seed, n_arc,
                       n_ring)
    free = grid_free(params)
    if occlusion_rings is None:
        return Problem(params, grid, free,
                       dict(pxm=mono_stack(grid, (256, 1024))), None)
    prep = band_grid(grid)
    if prep is None:
        raise RuntimeError("band_grid declined the occlusion rig")
    perm = prep.perm.long()
    params = dataclasses.replace(params, points=params.points[perm])
    free = dataclasses.replace(free, points=free.points[perm])
    R = params.ext_rot.shape[0]
    frozen = not bool(torch.any(flatten_camera(free)[6 * R:] != 0))
    bws, bbs = prep.widths
    return Problem(params, prep.grid, free,
                   dict(band_widths=bws, band_blocks=bbs,
                        band_intr_frozen=frozen),
                   dict(w_band=prep.w_band, w_band_cost=prep.w_band_cost,
                        lin_groups=prep.lin_groups,
                        cost_groups=prep.cost_groups))


def column_maps(template, step_kw):
    """(to_flat, to_nat): ``make_grid_step``'s maps between E's columns
    and the flat camera order (``solver.rig_grid.column_maps``) on the
    kernel path the step takes with ``step_kw``."""
    from deeparc_tpu_torch.solver.rig_grid import column_maps as maps

    return maps(template, True, step_kw.get("band_intr_frozen", False)
                and bool(step_kw.get("band_widths", (0, 0))[0]))


def schur_pieces(sys, radius, cam_free, point_free, options, maps):
    """The step's Schur solve run piece by piece in its order (the
    ``schur_*`` functions of ``solver/rig_grid.py``, which
    ``make_grid_step`` runs): ({piece name: a call that re-runs that piece
    on the earlier pieces' outputs}, dc, dp)."""
    from deeparc_tpu_torch.solver.rig_grid import (
        schur_back,
        schur_cameras,
        schur_point_blocks,
        schur_reduce,
    )

    to_flat, to_nat = maps
    binv, d2c = schur_point_blocks(sys, radius, point_free, options)
    rhs, corr = schur_reduce(sys, binv, cam_free, to_flat)
    dc = schur_cameras(sys, d2c, corr, rhs, radius, cam_free)
    _, dp = schur_back(sys, binv, dc, point_free, to_nat)
    calls = (lambda: schur_point_blocks(sys, radius, point_free, options),
             lambda: schur_reduce(sys, binv, cam_free, to_flat),
             lambda: schur_cameras(sys, d2c, corr, rhs, radius, cam_free),
             lambda: schur_back(sys, binv, dc, point_free, to_nat))
    return dict(zip(PIECES, calls)), dc, dp


def start(prob: Problem, options: SolverOptions):
    """(step, state, flat free camera mask, linearize, trial cost) at the
    problem's start iterate, as ``solve_ba_grid`` builds them."""
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.solver.rig_grid import (
        assemble_grid_system,
        grid_cost,
        init_grid_state,
        make_grid_step,
        slot_params,
    )

    kw = prob.step_kw
    params, grid = prob.params, prob.grid
    step = make_grid_step(options, params, **kw)
    state = init_grid_state(
        params, grid, options, band_widths=kw.get("band_widths", (0, 0)),
        band_blocks=kw.get("band_blocks", (0, 0)), pxm=kw.get("pxm"))
    sp = slot_params(params, grid)
    cam_free = flatten_camera(prob.free)
    bw, bb = kw.get("band_widths", (0, 0)), kw.get("band_blocks", (0, 0))
    lin = lambda: assemble_grid_system(
        params.points, sp, grid, cam_free, prob.free.points,
        band_width=bw[0], band_block=bb[0],
        band_intr_frozen=kw.get("band_intr_frozen", False), pxm=kw.get("pxm"))
    cost = lambda: grid_cost(params.points, sp, grid, band_width=bw[1],
                             band_block=bb[1], pxm=kw.get("pxm"))
    return step, state, cam_free, lin, cost


def run(device="cuda", n_points=None, occlusion_rings=None,
        reps: int = 5) -> dict:
    """The measurement as a dict (the JSON line's fields)."""
    from deeparc_tpu_torch.kernels import reset_launch_counts
    from deeparc_tpu_torch.solver.rig_grid import slot_params

    dev = check_device(device)
    if n_points is None:
        n_points = (UNIFORM_POINTS if occlusion_rings is None
                    else FLAGSHIP_POINTS)
    options = SolverOptions()
    prob = problem(n_points, occlusion_rings, dev)
    reset_launch_counts()
    step, state, cam_free, lin, cost = start(prob, options)
    t = lambda fn: time_ms(fn, reps, dev)
    pf, radius = prob.free.points, state.tr.radius
    out = {"slot_params_ms": t(lambda: slot_params(prob.params, prob.grid)),
           "assemble_ms": t(lin), "trial_cost_ms": t(cost)}
    sys_ = lin()
    calls, _, _ = schur_pieces(sys_, radius, cam_free, pf, options,
                               column_maps(prob.params, prob.step_kw))
    schur = {name: t(fn) for name, fn in calls.items()}
    e_shape = list(sys_.E.shape)
    e_bytes = sys_.E.numel() * sys_.E.element_size()
    del sys_, calls
    full = t(lambda: step(state, prob.grid, cam_free, pf))
    rest = full - out["assemble_ms"] - out["trial_cost_ms"]
    pieces = sum(schur.values())
    grid = prob.grid
    out.update(
        card_fields(dev), n_points=n_points, occlusion_rings=occlusion_rings,
        n_cells=int(grid.mask.shape[1]), n_obs_alive=int(grid.mask.sum()),
        grid_slots=int(grid.mask.numel()), dtype="float64", reps=reps,
        banded=prob.band is not None, band=prob.band,
        e_shape=e_shape,
        e_gbytes=e_bytes / 1e9, radius=float(radius),
        schur_ms=schur, schur_pieces_sum_ms=pieces, full_step_ms=full,
        schur_rest_ms=rest,
        pieces_over_rest=(pieces + out["slot_params_ms"]) / rest if rest > 0
        else None, launches=launch_counts())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--n-points", type=int, default=None,
                    help=f"points of the rig (default {UNIFORM_POINTS}, "
                         f"{FLAGSHIP_POINTS} with --occlusion-rings)")
    ap.add_argument("--occlusion-rings", type=int, default=None,
                    help="see each point from a cyclic window of this many "
                         "rings and take the banded kernels (6: the "
                         "flagship)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.n_points, args.occlusion_rings,
                         args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

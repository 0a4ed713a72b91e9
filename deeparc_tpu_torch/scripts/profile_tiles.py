"""Time the pieces of one tile-engine LM step at BAL scale.

    python -m deeparc_tpu_torch.scripts.profile_tiles [--bal | --rig] \\
        [--impl pallas|xla] [--n-points N] [--window 128] [--cg-iters 30]
    python -m deeparc_tpu_torch.scripts.profile_tiles --device cpu \\
        --n-points 4000 --n-cameras 64         # plain versions, small

The counterpart of the reference's ``scripts/profile_tiles.py`` and
``scripts/profile_tiles_step.py``. The scene is built on the device in the
tile layout (float64): ``--bal`` (default) ``make_bal_tile_device`` (2000
cameras, 1M points, track 8, each chunk's tracks drawn from a window of
``--window`` cameras, 128 by default: the locality path of
``tile_linearize_local`` / ``tile_sweep_local``; ``--window 0`` draws them
over all cameras: the global cell table of ``tile_sweep``), ``--rig``
``make_tile_rig_device`` (8 x 24 cells, 400k points, track 10). The free
mask is the generator's; ``--impl pallas`` is the kernel path, ``xla`` the
torch chunk linearize and sweeps (``dual`` raises, as in the solver).

From the start state (ITERATIVE_SCHUR, ``--cg-iters`` PCG iterations at
most) each piece is timed alone, the median of ``--reps`` runs (CUDA
events on the card): the linearize (``linearize_tiles_mixed`` /
``linearize_tiles``), the kernel path's sweep set-up (its planes and
sorted jcam copies, ``_make_kernel_sweeps``), one rhs, one matvec and one
edot sweep with the step's point blocks, and the trial cost
(``tile_cost``); then the whole step. Each sweep row has its bound: the
bytes of its kernel's planes and vectors (each read once, its output
written once; ``chip_smoke.py`` phase 6's counts) over the memory rate,
or its slots' operations (``OPS_PER_SLOT``) over the float64 peak,
whichever is larger; a row faster than its bound by more than
``SHARE_LIMIT`` raises. The step's estimate is the pieces with as many
matvec sweeps as its PCG ran. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.scripts import (
    OPS_PER_SLOT,
    bound,
    card_fields,
    check_share,
    launch_counts,
    nbytes,
    time_ms,
)

BAL_POINTS = 1_000_000
RIG_POINTS = 400_000
N_CAMERAS = 2000
WINDOW = 128
CG_ITERATIONS = 30
MODES = ("rhs", "matvec", "edot")


def scene(kind: str, n_points, n_cameras, window, device):
    """(params_t, tiles, cam_free) of the generated scene (module
    docstring)."""
    from deeparc_tpu_torch.io import make_bal_tile_device, make_tile_rig_device

    if kind == "bal":
        params, tiles, _, cam_free = make_bal_tile_device(
            n_cameras=n_cameras, n_points=n_points or BAL_POINTS,
            track_length=8, pixel_noise=1.0, point_noise=0.02, seed=0,
            dtype=torch.float64, window=window or None, device=device)
    elif kind == "rig":
        params, tiles, _, cam_free = make_tile_rig_device(
            n_arc=8, n_ring=24, n_points=n_points or RIG_POINTS,
            track_length=10, pixel_noise=1.0, point_noise=0.02, seed=0,
            dtype=torch.float64, device=device)
    else:
        raise ValueError(f"unknown scene {kind!r}")
    return params, tiles, cam_free


def sweep_work(tiles, sys, planes, V):
    """{mode: (bytes, operations)} of one sweep: per bucket the kernel's
    planes (or the torch sweep's blocks) and its point and cell vectors,
    each read once, its output written once; the operations over its
    slots."""
    esz = sys.g_p.element_size()
    work = dict.fromkeys(MODES, (0, 0))
    for i, b in enumerate(tiles.buckets):
        Nb, W = b.cell.shape
        if planes[i] is not None:
            jac = nbytes(*planes[i][:3])
        else:
            blk = sys.blocks[i]
            jac = nbytes(blk.j_x, blk.j_cam, b.cell)
        # the cell-space vector in and the bins out: per chunk with local
        # tables on the kernel path, (V, 18) otherwise
        cells = (b.loc[1].numel() if b.loc and planes[i] is not None
                 else V) * 18 * esz
        moved = {"rhs": jac + 12 * Nb * esz + cells,
                 "matvec": jac + 9 * Nb * esz + 2 * cells,
                 "edot": jac + cells + 3 * Nb * esz}
        for m in MODES:
            work[m] = (work[m][0] + moved[m],
                       work[m][1] + W * Nb * OPS_PER_SLOT[m])
    return work


def profile(device="cuda", kind="bal", impl="pallas", n_points=None,
            n_cameras=N_CAMERAS, window=WINDOW, cg_iters=CG_ITERATIONS,
            reps: int = 5):
    """(the measurement as a dict, the step's next state, its info)."""
    from deeparc_tpu_torch.kernels import reset_launch_counts
    from deeparc_tpu_torch.solver.rig_grid import slot_params
    from deeparc_tpu_torch.solver.schur import augmented_point_blocks
    from deeparc_tpu_torch.solver.tiles import (
        _e_dot_cells,
        _e_sweep,
        _make_kernel_sweeps,
        init_tile_state,
        linearize_tiles,
        linearize_tiles_mixed,
        make_tile_step,
        pack_cells,
        tile_cost,
    )

    dev = check_device(device)
    opts = SolverOptions(linear_solver="iterative_schur",
                         cg_max_iterations=cg_iters)
    if impl == "dual":
        make_tile_step(opts, None, impl=impl)   # raises, as the solver does
    params, tiles, cam_free = scene(kind, n_points, n_cameras, window, dev)
    step = make_tile_step(opts, params, impl=impl)
    reset_launch_counts()
    pf = torch.ones_like(params.points)
    C, V = cam_free.numel(), tiles.cells.cols.shape[0]
    state = init_tile_state(params, tiles, opts, cam_free)
    packed = pack_cells(slot_params(params, tiles.cells), tiles.cells,
                        cam_free)
    kernels = impl != "xla"
    if kernels:
        lin = lambda: linearize_tiles_mixed(params.points, packed, tiles, pf,
                                            C)
        sys_, planes = lin()
    else:
        lin = lambda: linearize_tiles(params.points, packed, tiles, pf, C)
        sys_, planes = lin(), (None,) * len(tiles.buckets)
    t = lambda fn: time_ms(fn, reps, dev)
    ms = {"linearize": t(lin)}
    binv = augmented_point_blocks(sys_.hpp, pf, state.tr.radius, opts)
    if kernels:
        setup = lambda: _make_kernel_sweeps(tiles, sys_, binv, planes, None,
                                            256)
        ms["sweep_setup"] = t(setup)
        sweep, edot = setup()
    else:
        sweep = lambda v, rhs: _e_sweep(tiles, sys_, binv, v, rhs)
        edot = lambda v: _e_dot_cells(tiles, sys_, v)
    v = torch.randn((V, 18), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    ms["sweep_rhs"] = t(lambda: sweep(None, True))
    ms["sweep_matvec"] = t(lambda: sweep(v, False))
    ms["edot"] = t(lambda: edot(v))
    ms["trial_cost"] = t(lambda: tile_cost(params.points, packed, tiles))
    work = sweep_work(tiles, sys_, planes, V)
    bounds = {}
    for m, key in zip(MODES, ("sweep_rhs", "sweep_matvec", "edot")):
        b_ms, b_by = bound(*work[m], "float64")
        bounds[m] = dict(bound_ms=b_ms, bound_by=b_by, gbytes=work[m][0] / 1e9,
                         share=check_share(f"{key} ({impl})",
                                           b_ms / ms[key]))
    del sys_, planes, binv, sweep, edot
    run = lambda: step(state, tiles, cam_free, pf)
    nxt, info = run()
    ms["step"] = t(run)
    n_cg = int(info.cg_iters)
    ms["est_step"] = (ms["linearize"] + ms.get("sweep_setup", 0.0)
                      + ms["sweep_rhs"] + ms["edot"] + ms["trial_cost"]
                      + n_cg * ms["sweep_matvec"])
    res = dict(
        card_fields(dev), scene=kind, impl=impl, dtype="float64", reps=reps,
        n_point_rows=int(params.points.shape[0]), cells=V,
        window=window if kind == "bal" else None,
        live_obs=int(sum(float(b.mask.sum()) for b in tiles.buckets)),
        buckets=[list(b.cell.shape) for b in tiles.buckets],
        local_tables=[bool(b.loc) for b in tiles.buckets],
        cg_iters=cg_iters, cg_iterations_run=n_cg,
        accepted=bool(info.accepted),
        **{f"{k}_ms": x for k, x in ms.items()}, sweep_bounds=bounds,
        launches=launch_counts())
    return res, nxt, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--bal", dest="kind", action="store_const", const="bal",
                    default="bal", help="the BAL scene (default)")
    ap.add_argument("--rig", dest="kind", action="store_const", const="rig",
                    help="the 8 x 24-cell turntable rig")
    ap.add_argument("--impl", default="pallas",
                    choices=("pallas", "xla", "dual"))
    ap.add_argument("--n-points", type=int, default=None,
                    help=f"points (default {BAL_POINTS} BAL, {RIG_POINTS} "
                         f"rig)")
    ap.add_argument("--n-cameras", type=int, default=N_CAMERAS)
    ap.add_argument("--window", type=int, default=WINDOW,
                    help="BAL tracks' camera window (0: all cameras)")
    ap.add_argument("--cg-iters", type=int, default=CG_ITERATIONS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.device, args.kind, args.impl,
                             args.n_points, args.n_cameras, args.window,
                             args.cg_iters, args.reps)[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

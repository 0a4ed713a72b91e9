"""A shared-extrinsic rig solved on the grid engine: ``solve_ba_grid`` at
its public defaults (impl and band ``auto``, the Python LM driver, no
``band_reuse``, so every solve runs its own band prep) on the grid that
``grid_from_scene`` builds in set-up, with the pipeline's full-BA round
as the free mask (``freeze_masks(scene)``, points masked as its rounds
mask them)."""

from __future__ import annotations

import dataclasses

from portbench import answers, judge

UNIT = "solve"


def setup(ctx) -> dict:
    import torch

    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.scene import from_deeparc
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene

    scene = from_deeparc(ctx["data"], dtype=torch.float64,
                         device=ctx["device"])
    grid = grid_from_scene(scene)
    free = answers.program_free(scene, ctx["config"])
    free = dataclasses.replace(
        free, points=free.points * grid.point_mask[:, None])
    return {"params": scene.params, "grid": grid, "free": free,
            "options": SolverOptions(**ctx["config"]["solver"])}


def call(state) -> dict:
    from deeparc_tpu_torch.solver.rig_grid import solve_ba_grid

    res = solve_ba_grid(state["params"], state["grid"], state["free"],
                        state["options"])
    return {"answer": {"points": answers.host(res.params.points),
                       "cameras": answers.cameras_of(res.params),
                       "cost": res.cost},
            "lm_seconds": res.seconds, "iterations": res.iterations,
            "cg_iterations": res.cg_iterations}


def probe(state, ctx) -> dict:
    """One classic LM step at the start iterate on the solve's own layout
    (band prep when it finds locality, else the monolithic plane stack),
    and its linearize (``assemble_grid_system``) and trial cost
    (``grid_cost``) alone: each its device time on the profiler's trace,
    the median of 3."""
    import torch

    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.solver.rig_band import band_grid
    from deeparc_tpu_torch.solver.rig_grid import (
        assemble_grid_system,
        grid_cost,
        init_grid_state,
        make_grid_step,
        mono_stack,
        slot_params,
    )

    from portbench.trace import device_ms

    params, grid, free = state["params"], state["grid"], state["free"]
    opts = state["options"]
    prep = band_grid(grid)
    cam_free = flatten_camera(free)
    if prep is None:
        pxm = mono_stack(grid, (256, 1024))
        init_kw = step_kw = lin_kw = cost_kw = {"pxm": pxm}
        pf = free.points
    else:
        perm = prep.perm.long()
        grid = prep.grid
        params = dataclasses.replace(params, points=params.points[perm])
        pf = free.points[perm]
        R = params.ext_rot.shape[0]
        frozen = not bool(torch.any(cam_free[6 * R:] != 0))
        bws, bbs = prep.widths
        init_kw = {"band_widths": bws, "band_blocks": bbs}
        step_kw = dict(init_kw, band_intr_frozen=frozen)
        lin_kw = {"band_width": bws[0], "band_block": bbs[0],
                  "band_intr_frozen": frozen}
        cost_kw = {"band_width": bws[1], "band_block": bbs[1]}
    step = make_grid_step(opts, params, **step_kw)
    st = init_grid_state(params, grid, opts, **init_kw)
    sp = slot_params(params, grid)
    return {
        "banded": prep is not None,
        "step_ms": device_ms(lambda: step(st, grid, cam_free, pf)),
        "linearize_ms": device_ms(lambda: assemble_grid_system(
            params.points, sp, grid, cam_free, pf, **lin_kw)),
        "cost_ms": device_ms(lambda: grid_cost(params.points, sp, grid,
                                              **cost_kw))}


def reference(ctx, dtype) -> dict:
    return answers.reference_solve(ctx, dtype)


def gaps(answer, ref, ctx) -> dict:
    return judge.solve_gaps(answer, ref, ctx["start"])

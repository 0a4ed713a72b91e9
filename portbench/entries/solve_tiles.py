"""A scene of independent cameras solved on the tile engine:
``solve_tiles_prepared`` at its public defaults (impl ``auto``, the Python
LM driver, points returned in the caller's order) on the layout that
``tiles_from_scene`` builds in set-up, with the pipeline's full-BA round
as the free mask (``freeze_masks(scene)``), and the intrinsics that the
configuration's ``free_intrinsics`` names freed as well."""

from __future__ import annotations

from portbench import answers, judge

UNIT = "solve"


def setup(ctx) -> dict:
    import torch

    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import from_deeparc
    from deeparc_tpu_torch.solver.tiles import tiles_from_scene

    scene = from_deeparc(ctx["data"], dtype=torch.float64,
                         device=ctx["device"])
    free = answers.program_free(scene, ctx["config"])
    tiles, params_t, free_t = tiles_from_scene(scene, free)
    return {"params": params_t, "tiles": tiles, "free_t": free_t,
            "cam_free": flatten_camera(free),
            "options": SolverOptions(**ctx["config"]["solver"])}


def call(state) -> dict:
    from deeparc_tpu_torch.solver.tiles import solve_tiles_prepared

    res = solve_tiles_prepared(state["params"], state["tiles"],
                               state["free_t"], state["cam_free"],
                               state["options"])
    return {"answer": {"points": answers.host(res.params.points),
                       "cameras": answers.cameras_of(res.params),
                       "cost": res.cost},
            "lm_seconds": res.seconds, "iterations": res.iterations,
            "cg_iterations": res.cg_iterations}


def probe(state, ctx) -> dict:
    """The linearize the step calls (``linearize_tiles_mixed``) at the
    start iterate: its device time on the profiler's trace, the median of
    3."""
    from deeparc_tpu_torch.solver.rig_grid import slot_params
    from deeparc_tpu_torch.solver.tiles import (
        linearize_tiles_mixed,
        pack_cells,
    )

    from portbench.trace import device_ms

    p, tiles, cam_free = state["params"], state["tiles"], state["cam_free"]
    opts = state["options"]
    packed = pack_cells(slot_params(p, tiles.cells), tiles.cells, cam_free)
    return {"linearize_ms": device_ms(lambda: linearize_tiles_mixed(
        p.points, packed, tiles, state["free_t"], cam_free.shape[0],
        opts.loss, opts.loss_scale))}


def reference(ctx, dtype) -> dict:
    return answers.reference_solve(ctx, dtype)


def gaps(answer, ref, ctx) -> dict:
    return judge.solve_gaps(answer, ref, ctx["start"])

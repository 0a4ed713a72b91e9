"""BFS incremental bundle adjustment of a shared rig, as the CLI's
``--incremental`` runs it: ``run_incremental`` at the configuration's
solver options on the scene's ``.deeparc`` contents, one ring of cells a
batch, each batch a structure-only solve and a full BA on the grid
engine, a point solved once two of its observations are active. One call
is one whole reconstruction. No files are written."""

from __future__ import annotations

from portbench import answers, judge
from portbench import incremental as inc
from portbench import reference as ref

UNIT = "pipeline"


def _plan(cfg) -> dict:
    """The configuration's ``incremental`` block: the batch size, the
    observations that make a point live, and the BFS order from cell 0,
    the one order the program runs."""
    plan = cfg["incremental"]
    if plan["order"] != "bfs" or plan["start_cell"] != 0:
        raise ValueError(f"the program runs a BFS order from cell 0, not "
                         f"{plan}")
    return plan


def setup(ctx) -> dict:
    from deeparc_tpu_torch.config import PipelineOptions, SolverOptions

    cfg = ctx["config"]
    return {"data": ctx["data"], "device": ctx["device"],
            "plan": _plan(cfg),
            "options": PipelineOptions(
                solver=SolverOptions(**cfg["solver"]))}


def call(state) -> dict:
    from deeparc_tpu_torch.pipeline.incremental import run_incremental

    plan = state["plan"]
    res = run_incremental(state["data"], state["options"],
                          batch_size=plan["batch_size"],
                          device=state["device"], verbose=False,
                          min_observations=plan["min_observations"])
    params = res.scene.params
    return {"answer": {"points": answers.host(params.points),
                       "cameras": answers.cameras_of(params),
                       "cost": res.final_cost},
            "lm_seconds": res.solve_seconds,
            "iterations": res.solve_iterations,
            "cg_iterations": res.cg_iterations}


def probe(state, ctx) -> dict:
    return {}


def reference(ctx, dtype) -> dict:
    cfg = ctx["config"]
    plan = _plan(cfg)
    out = inc.run(ctx["data"], ref.Options.of(cfg["solver"]),
                  plan["batch_size"], dtype, ctx["device"],
                  plan["start_cell"], plan["min_observations"])
    return {"points": answers.host(out["points"]),
            "cameras": answers.host(ref.camera_vector(out["ext"],
                                                      out["intr"])),
            "cost": out["cost"], "history": out["history"]}


def gaps(answer, ref_answer, ctx) -> dict:
    # no filter runs: every point of the scene is in both answers
    return judge.solve_gaps(answer, ref_answer, ctx["start"])

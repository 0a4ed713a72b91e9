"""BFS incremental bundle adjustment of independent cameras with pose-graph
refinement, as the CLI's ``--incremental`` runs a non-shared scene:
``run_incremental`` at the configuration's solver options on the scene's
``.deeparc`` contents, a batch of cameras at a time, each batch a
structure-only solve, a pose graph over the registered poses and a full
BA, all on one tile layout of the scene. One call is one whole
reconstruction. No files are written.

Besides the solve's gaps, the judge counts the positions where the BFS
order differs from the reference's (``order_mismatch``) and the pose-graph
edges, as (i, j, batch captured), that one side has and the other lacks
(``edges_mismatch``)."""

from __future__ import annotations

import numpy as np

from portbench import answers, judge
from portbench import incremental_free as inc
from portbench import reference as ref

UNIT = "pipeline"


# the program's rule on a non-shared scene: a BFS order from camera 0, a
# point live at 2 active observations, an edge at 3 shared points, at most
# 20 pose-graph LM steps a batch
RULE = {"order": "bfs", "start_camera": 0, "min_observations": 2,
        "pose_graph": True, "min_covis": 3, "pose_graph_iterations": 20}


def _plan(cfg) -> dict:
    """The configuration's ``incremental`` block, which has to be the
    program's rule (``RULE``) with a batch size."""
    plan = cfg["incremental"]
    if {k: plan[k] for k in RULE} != RULE:
        raise ValueError(f"the program runs {RULE}, not {plan}")
    return plan


def setup(ctx) -> dict:
    from deeparc_tpu_torch.config import PipelineOptions, SolverOptions
    from deeparc_tpu_torch.pipeline.incremental import IncrementalResult

    if "edges" not in IncrementalResult._fields:
        raise RuntimeError("run_incremental returns no pose-graph edges, "
                           "which the judge compares")
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
                          device=state["device"], verbose=False)
    params = res.scene.params
    return {"answer": {"points": answers.host(params.points),
                       "cameras": answers.cameras_of(params),
                       "cost": res.final_cost,
                       "order": np.asarray(res.order, np.int64),
                       "edges": np.asarray(res.edges, np.int64)},
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
                  plan["start_camera"], plan["min_observations"],
                  plan["min_covis"], plan["pose_graph_iterations"])
    return {"points": answers.host(out["points"]),
            "cameras": answers.host(ref.camera_vector(out["ext"],
                                                      out["intr"])),
            "cost": out["cost"], "order": out["order"],
            "edges": out["edges"], "history": out["history"]}


def _rows(a) -> set:
    return {tuple(int(v) for v in row) for row in np.asarray(a)}


def gaps(answer, ref_answer, ctx) -> dict:
    out = judge.solve_gaps(answer, ref_answer, ctx["start"])
    a, r = answer["order"], ref_answer["order"]
    out["order_mismatch"] = (float(np.count_nonzero(a != r))
                             if a.shape == r.shape else judge.INF)
    out["edges_mismatch"] = float(len(_rows(answer["edges"])
                                      ^ _rows(ref_answer["edges"])))
    return out

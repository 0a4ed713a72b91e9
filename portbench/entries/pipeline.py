"""What an ``sfm`` user waits for: ``run_pipeline`` at its public defaults
(``PipelineOptions()``) on the scene's ``.deeparc`` contents: load, the
hemisphere fit, the points-only solve, the filter, and solve/filter rounds
until the point count stops changing. No files are written
(``output_dir=None``)."""

from __future__ import annotations

import numpy as np

from portbench import answers, judge
from portbench import reference as ref

UNIT = "pipeline"


def setup(ctx) -> dict:
    return {"data": ctx["data"], "device": ctx["device"]}


def call(state) -> dict:
    from deeparc_tpu_torch.config import PipelineOptions
    from deeparc_tpu_torch.pipeline import run_pipeline

    data = state["data"]
    res = run_pipeline(data, PipelineOptions(), output_dir=None,
                       verbose=False, device=state["device"])
    scene = res.scene
    keys = answers.obs_keys(answers.host(scene.index.obs_point).astype(
        np.int64), scene.meta.obs_arc, scene.meta.obs_ring, data.ring_size,
        data.arc_size)
    return {"answer": {"points": answers.host(scene.params.points),
                       "cameras": answers.cameras_of(scene.params),
                       "cost": res.final_cost,
                       "hemisphere": np.asarray(res.hemisphere, np.float64),
                       "obs_keys": np.sort(keys)},
            "lm_seconds": res.solve_seconds,
            "iterations": res.solve_iterations,
            "cg_iterations": res.cg_iterations}


def probe(state, ctx) -> dict:
    return {}


def reference(ctx, dtype) -> dict:
    cfg, data = ctx["config"], ctx["data"]
    out = ref.pipeline(data, ref.Options.of(cfg["solver"]),
                       cfg["filter_boundary"], cfg["hemisphere_iterations"],
                       cfg["max_filter_rounds"], dtype, ctx["device"])
    alive = answers.host(out["point_alive"]).astype(bool)
    obs = answers.host(out["obs_alive"]).astype(bool)
    new_id = np.cumsum(alive) - 1
    keys = answers.obs_keys(new_id[data.obs_point[obs]], data.obs_arc[obs],
                            data.obs_ring[obs], data.ring_size,
                            data.arc_size)
    return {"points": answers.host(out["points"])[alive],
            "cameras": answers.host(ref.camera_vector(out["ext"],
                                                      out["intr"])),
            "cost": out["final_cost"],
            "hemisphere": answers.host(out["hemisphere"]),
            "obs_keys": np.sort(keys),
            "point_alive": alive}


def gaps(answer, ref_answer, ctx) -> dict:
    return judge.pipeline_gaps(answer, ref_answer, ctx["start"])

"""Seconds a pipeline spends outside its LM loops: each pipeline's wall
time less its ``PipelineResult.solve_seconds``, averaged over the
window."""


def read(rec):
    if rec["unit"] != "pipeline":
        return None
    calls = rec["calls"]
    return sum(c["wall"] - c["lm_seconds"] for c in calls) / len(calls)

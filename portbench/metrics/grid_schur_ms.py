"""Milliseconds of a grid LM step outside its linearize and trial cost
(the Schur solve and the step's decision), at the start iterate: the
classic step less ``assemble_grid_system`` and ``grid_cost`` each timed
alone, each its device time on the profiler's trace."""


def read(rec):
    p = rec["probe"] or {}
    if "step_ms" not in p:
        return None
    return p["step_ms"] - p["linearize_ms"] - p["cost_ms"]

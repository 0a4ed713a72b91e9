"""Percent of its roofline that one linearize at the start iterate
reaches: the least time of its work counted from the problem's sizes
(``portbench/roofline.py``) over its device time on the profiler's trace. Above 105%
the count or the time is wrong, and it raises.
In the grid engine's cells (``assemble_grid_system``)."""

from portbench.roofline import least_seconds


def read(rec):
    p, work = rec["probe"] or {}, rec["work"]
    if "linearize_ms" not in p or work is None:
        return None
    share = 100.0 * least_seconds(*work["linearize"]) / (
        p["linearize_ms"] * 1e-3)
    if share > 105.0:
        raise ValueError(f"linearize at {share}% of its roofline")
    return share

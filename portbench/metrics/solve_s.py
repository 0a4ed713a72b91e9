"""Seconds a solve: the window's seconds over the whole solves completed
in it (every solve from the same start to convergence).
In the grid engine's cells (the rig)."""


def read(rec):
    if rec["unit"] != "solve":
        return None
    return rec["window_s"] / len(rec["calls"])

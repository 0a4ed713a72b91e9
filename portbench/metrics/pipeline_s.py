"""Seconds a pipeline: the window's seconds over the whole pipelines
completed in it."""


def read(rec):
    if rec["unit"] != "pipeline":
        return None
    return rec["window_s"] / len(rec["calls"])

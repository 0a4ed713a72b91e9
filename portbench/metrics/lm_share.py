"""The LM loops' share of the window (``BAResult.seconds`` summed over the
window's solves, over its length); the rest is each solve's own
preparation: band prep, plane stacks, step build, sorted copies.
In the grid engine's cells."""


def read(rec):
    if rec["unit"] != "solve":
        return None
    return sum(c["lm_seconds"] for c in rec["calls"]) / rec["window_s"]

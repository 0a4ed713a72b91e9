"""Milliseconds an LM iteration: the LM loops' seconds
(``BAResult.seconds``) over their iterations, summed over the window's
solves.
In the grid engine's cells."""


def read(rec):
    its = sum(c["iterations"] for c in rec["calls"])
    if rec["unit"] != "solve" or not its:
        return None
    return 1e3 * sum(c["lm_seconds"] for c in rec["calls"]) / its

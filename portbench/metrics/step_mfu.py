"""Percent of the card's peak that a whole LM iteration reaches: the
least time of the two passes over the observations every iteration
makes (a linearize and a trial cost, counted from the problem's sizes)
over the window's milliseconds an LM iteration. Above 105% it raises.
In the grid engine's cells."""

from portbench.roofline import least_seconds


def read(rec):
    its = sum(c["iterations"] for c in rec["calls"])
    if rec["unit"] != "solve" or not its or rec["work"] is None:
        return None
    per_iter = sum(c["lm_seconds"] for c in rec["calls"]) / its
    least = (least_seconds(*rec["work"]["linearize"])
             + least_seconds(*rec["work"]["cost"]))
    share = 100.0 * least / per_iter
    if share > 105.0:
        raise ValueError(f"an LM iteration at {share}% of the peak")
    return share

"""Milliseconds an LM iteration of an incremental reconstruction: the
calls' LM seconds (``IncrementalResult.solve_seconds``, every batch's
structure and full solve) over their LM iterations, summed over the
window."""


def read(rec):
    its = sum(c["iterations"] for c in rec["calls"])
    if rec["unit"] != "pipeline" or not its:
        return None
    return 1e3 * sum(c["lm_seconds"] for c in rec["calls"]) / its

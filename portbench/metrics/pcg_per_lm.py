"""PCG iterations an LM iteration, summed over the window's solves."""


def read(rec):
    its = sum(c["iterations"] for c in rec["calls"])
    cg = sum(c["cg_iterations"] for c in rec["calls"])
    if rec["unit"] != "solve" or not its or not cg:
        return None
    return cg / its

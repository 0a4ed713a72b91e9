"""The device's idle share over a profiled sub-window of whole pipelines:
1 - busy / window on the device's clock (``portbench/trace.py``)."""

from portbench.trace import idle_share


def read(rec):
    prof = rec["profile"]
    if rec["unit"] != "pipeline" or prof is None:
        return None
    return idle_share(prof["busy_s"], prof["window_s"])

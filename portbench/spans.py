"""What the span readers (``metrics/``) read: the program's spans
(``deeparc_tpu_torch.utils.profiling.spans``) of the traced run's whole
calls, and the share of the device's idle time that the profiler's trace
finds in no named host range.

Only records whose root is a ``deeparc.solve`` or ``deeparc.pipeline``
span are read. Those roots open only in ``trace.profile_calls``' whole
calls: the window's calls run with tracing off, and the probes call the
engines' parts below any root. A program without spans (or a run
without a profile, as on the CPU) gives no records, and the readers
return None.
"""

from __future__ import annotations

# ``trace.profile_calls``' name for idle time in no host range
UNNAMED = "host work outside traced ops"


def rooted(root: str):
    """(number of closed ``root`` spans, {name: closed records under
    them}), or None where there are none."""
    try:
        from deeparc_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    recs = [r for r in spans() if r["end_ns"] is not None]
    roots = {r["id"] for r in recs
             if r["name"] == root and r["root"] == r["id"]}
    if not roots:
        return None
    by_name: dict = {}
    for r in recs:
        if r["root"] in roots:
            by_name.setdefault(r["name"], []).append(r)
    return len(roots), by_name


def host_s(records) -> float:
    """The records' summed host seconds."""
    return sum(r["end_ns"] - r["start_ns"] for r in records) * 1e-9


def per_root_s(root: str, names) -> float | None:
    """Host seconds of the spans ``names`` per ``root`` span; None where
    there is no root or none of the spans."""
    got = rooted(root)
    if got is None:
        return None
    n, by_name = got
    recs = [r for name in names for r in by_name.get(name, ())]
    return host_s(recs) / n if recs else None


def device_ms_per(name: str, per) -> float | None:
    """Milliseconds of the device time of the ``name`` spans of whole
    solves per unit of ``per(by_name)`` (e.g. LM steps); None where a span
    holds no device time (no card) or there are no units."""
    got = rooted("deeparc.solve")
    if got is None:
        return None
    by_name = got[1]
    dev = [r["device_s"] for r in by_name.get(name, ())]
    units = per(by_name)
    if not dev or None in dev or not units:
        return None
    return sum(dev) / units * 1e3


def unnamed_share(rec, unit: str) -> float | None:
    """The idle time that the profile's ``idle_gaps`` put in no named host
    range, over the device's idle time (window less busy). Where that
    entry is not among the ten largest, the tenth's value: an upper
    bound."""
    prof = rec["profile"]
    if rec["unit"] != unit or prof is None:
        return None
    idle = prof["window_s"] - prof["busy_s"]
    if not idle > 0:
        return None
    gaps = prof["idle_gaps"]
    named = dict(gaps)
    if UNNAMED in named:
        value = named[UNNAMED]
    else:
        value = gaps[-1][1] if len(gaps) >= 10 else 0.0
    return value / idle

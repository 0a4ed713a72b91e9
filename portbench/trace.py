"""Readings of the device's trace: the busy time and idle share over a
profiled sub-window of whole calls, the breakdown the result line
carries, and the device time of one call between two marker kernels.

The window lies between two marker kernels (``torch.cuda._sleep``)
launched right before the first call and right after the last, so it is on
the device's clock and holds the host's work between and inside the calls;
busy is the union of the device's activities clipped to it. ``busy_in``
and ``idle_share`` are frozen copies of the program's
``deeparc_tpu_torch/scripts`` arithmetic.
"""

from __future__ import annotations

import time

MARKER_CYCLES = 1000


def busy_in(intervals, lo: float, hi: float) -> float:
    """The time of [lo, hi] that the (start, end) intervals cover: their
    union, each clipped to the window; one clock for all."""
    busy, cur_lo, cur_hi = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur_hi is not None and a <= cur_hi:
            cur_hi = max(cur_hi, b)
            continue
        if cur_hi is not None:
            busy += cur_hi - cur_lo
        cur_lo, cur_hi = a, b
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy


def idle_share(busy: float, window: float) -> float:
    """1 - busy / window; outside [0, 1] (past rounding) the two were not
    measured over one window on one clock, and it raises."""
    if not window > 0:
        raise ValueError(f"an idle share over an empty window ({window})")
    share = 1.0 - busy / window
    if not -1e-9 <= share <= 1.0:
        raise ValueError(f"idle share {share} outside [0, 1]: device busy "
                         f"{busy} of a {window} window")
    return max(share, 0.0)


def gaps_of(work, lo, hi):
    """The idle stretches (start, end) of [lo, hi] between the union of
    the ``work`` intervals."""
    out, cur = [], lo
    for a, b in sorted(work):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def _device_activities(prof) -> list:
    """(start, end, name) of the device's activities in a profile, on the
    device's clock in microseconds, by start."""
    from torch.autograd import DeviceType

    return sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def device_ms(fn, reps: int = 3) -> float:
    """Milliseconds the device works on one call of ``fn``, from the
    profiler's trace: the median over ``reps`` profiled calls, after a
    warm-up call, of the union of the device's activities between a
    marker kernel launched right before the call and one launched right
    after it (the host's launch gaps, and the profiler's own cost on the
    host, left out). Without a card (the tests' CPU runs, which time
    nothing of the card) the host's clock."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    times = []
    for _ in range(reps):
        if not torch.cuda.is_available():
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
            continue
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(MARKER_CYCLES)
            fn()
            torch.cuda._sleep(MARKER_CYCLES)
            torch.cuda.synchronize()
        acts = _device_activities(prof)
        if len(acts) < 3:
            raise RuntimeError("the profile holds no device work between "
                               "its markers")
        lo, hi = acts[0][1], acts[-1][0]
        times.append(busy_in([(a, b) for a, b, _ in acts[1:-1]], lo, hi)
                     * 1e-3)
    return statistics.median(times)


def profile_calls(call, state, min_seconds: float, min_calls: int = 1):
    """Whole calls of ``call(state)`` under the profiler, at least
    ``min_calls`` and until ``min_seconds`` have passed. Returns {busy_s,
    window_s, calls, device_ops, idle_gaps}: the device ops that took most
    time, and the idle time by the innermost host op running at each
    gap's middle (the ten largest each)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    n = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(MARKER_CYCLES)
        t0 = time.perf_counter()
        while n < min_calls or time.perf_counter() - t0 < min_seconds:
            call(state)
            n += 1
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    events = prof.events()
    acts = _device_activities(prof)
    if len(acts) < 3:
        raise RuntimeError("the profile holds no device work between its "
                           "markers")
    lo, hi = acts[0][1], acts[-1][0]
    work = acts[1:-1]
    busy = busy_in([(a, b) for a, b, _ in work], lo, hi)
    ops: dict = {}
    for a, b, name in work:
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.device_type == DeviceType.CPU
                  and e.time_range.end > lo and e.time_range.start < hi)
    gaps = sorted(gaps_of([(a, b) for a, b, _ in work], lo, hi),
                  key=lambda g: g[0] - g[1])[:200]
    idle: dict = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = [(e - s, name) for s, e, name in host if s <= mid <= e]
        name = min(inner)[1] if inner else "host work outside traced ops"
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "calls": n, "device_ops": top(ops), "idle_gaps": top(idle)}

"""Host-side phase timers and a profiler trace, PyTorch port of
``deeparc_tpu.utils.profiling``. On a CUDA device a phase's timer
synchronises the card at both ends, so the time is the card's work for
the phase and not only the time to queue it. :func:`trace_to` is the
counterpart of the reference's ``jax.profiler`` trace: a
``torch.profiler`` trace written as a Chrome trace."""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from collections import defaultdict

import torch

_PHASE_TOTALS: dict = defaultdict(float)
_PHASE_COUNTS: dict = defaultdict(int)


@contextlib.contextmanager
def phase_timer(name: str, sink: dict | None = None, device=None):
    """Accumulate wall time per named phase; read back via phase_report().
    ``device``: where the phase's tensors live; a CUDA device is
    synchronised when the phase starts and when it ends."""
    sync = device is not None and torch.device(device).type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    t0 = time.time()
    try:
        yield
    finally:
        if sync:
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        _PHASE_TOTALS[name] += dt
        _PHASE_COUNTS[name] += 1
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt


def phase_report() -> dict:
    return {name: {"total_s": _PHASE_TOTALS[name],
                   "count": _PHASE_COUNTS[name]}
            for name in _PHASE_TOTALS}


def reset_phases() -> None:
    _PHASE_TOTALS.clear()
    _PHASE_COUNTS.clear()


_TRACES = itertools.count()


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activities, plus
    CUDA activities when torch sees a card) and write a Chrome trace
    (``chrome://tracing``, Perfetto) into ``logdir`` on exit. Yields the
    profiler; its ``trace_path`` is set on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(
        logdir, f"trace_{os.getpid()}_{next(_TRACES)}.json")
    prof.export_chrome_trace(prof.trace_path)

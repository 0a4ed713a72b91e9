"""The port's tracing: named spans at its layer boundaries, on the
profiler's clock, and a profiler trace (:func:`trace_to`, the counterpart
of the reference's ``jax.profiler`` trace).

Tracing is on exactly while a ``torch.profiler`` session records (a
:func:`trace_to` block, the benchmark's ``--trace 1`` run). Off,
:func:`span` returns one shared no-op context: no record, no allocation,
no profiler range. On, a span opens ``torch.profiler.record_function``,
so the profiler's trace names the host time inside it on the same clock
as the device's activities, and appends one record to an in-memory list
(:func:`spans`): its id, its parent's and its root's ids (every span of
one solve or pipeline shares its root's id), its name, its host start
and end (``time.perf_counter_ns``) and its counts. ``device=True`` also
records a CUDA event at each end on the current stream (no
synchronisation; none under a CUDA graph capture), whose interval is the
span's ``device_s``.

Spans nest by the order they are opened and closed; the records are one
thread's.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

# past this many records new spans still open their profiler range but
# are not recorded; :func:`dropped_spans` counts them
MAX_SPANS = 1_000_000

_records: list = []
_events: dict = {}     # record id -> (start event, end event)
_open: list = []       # the open spans' records, innermost last
_ids = itertools.count(1)
_dropped = 0


class _NoSpan:
    """The span while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "device", "counts", "_range", "_rec")

    def __init__(self, name, device, counts):
        self.name, self.device, self.counts = name, device, counts

    def set(self, **counts) -> None:
        """Counts known only inside the span (e.g. ``iterations=``)."""
        self.counts.update(counts)

    def __enter__(self):
        global _dropped
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        parent = _open[-1] if _open else None
        rid = next(_ids)
        rec = {"id": rid, "parent": parent and parent["id"],
               "root": parent["root"] if parent else rid, "name": self.name,
               "start_ns": time.perf_counter_ns(), "end_ns": None,
               "counts": self.counts, "device_s": None}
        if len(_records) < MAX_SPANS:
            _records.append(rec)
        else:
            _dropped += 1
        if (self.device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            _events[rid] = (ev, None)
        _open.append(rec)
        self._rec = rec
        return self

    def __exit__(self, *exc):
        rec = self._rec
        ev = _events.get(rec["id"])
        if ev is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            _events[rec["id"]] = (ev[0], end)
        rec["end_ns"] = time.perf_counter_ns()
        _open.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str, device: bool = False, **counts):
    """A context manager naming the block ``name`` while tracing is on
    (the module's docstring); the shared no-op :data:`NO_SPAN` while it is
    off. ``counts`` are numbers recorded with the span; more can be set
    inside it with ``.set(**counts)``."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return _Span(name, device, counts)


def traced(name: str):
    """Decorator: the whole call inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def spans() -> list:
    """The records so far (dicts: ``id``, ``parent``, ``root``, ``name``,
    ``start_ns``, ``end_ns``, ``counts``, ``device_s``), their
    ``device_s`` resolved after one ``torch.cuda.synchronize`` where the
    span recorded events (else None)."""
    done = [k for k, (_, end) in _events.items() if end is not None]
    if done:
        torch.cuda.synchronize()
        by_id = {r["id"]: r for r in _records}
        for k in done:
            start, end = _events.pop(k)
            if k in by_id:
                by_id[k]["device_s"] = start.elapsed_time(end) * 1e-3
    return list(_records)


def _covered(intervals) -> int:
    """The length of the union of (start, end) intervals."""
    total, cur_lo, cur_hi = 0, None, None
    for a, b in sorted(intervals):
        if cur_hi is not None and a <= cur_hi:
            cur_hi = max(cur_hi, b)
            continue
        if cur_hi is not None:
            total += cur_hi - cur_lo
        cur_lo, cur_hi = a, b
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def span_report(records=None) -> dict:
    """Per span name over ``records`` (default: :func:`spans`), the closed
    spans' count, total host seconds, self seconds (each span's duration
    less the part its children cover), device seconds (None where no span
    of the name recorded events) and summed counts."""
    records = spans() if records is None else records
    closed = [r for r in records if r["end_ns"] is not None]
    children: dict = {}
    for r in closed:
        children.setdefault(r["parent"], []).append(r)
    out: dict = {}
    for r in closed:
        dur = r["end_ns"] - r["start_ns"]
        cover = _covered((max(c["start_ns"], r["start_ns"]),
                          min(c["end_ns"], r["end_ns"]))
                         for c in children.get(r["id"], ()))
        row = out.setdefault(r["name"], {"count": 0, "total_s": 0.0,
                                         "self_s": 0.0, "device_s": None,
                                         "counts": {}})
        row["count"] += 1
        row["total_s"] += dur * 1e-9
        row["self_s"] += (dur - cover) * 1e-9
        if r["device_s"] is not None:
            row["device_s"] = (row["device_s"] or 0.0) + r["device_s"]
        for k, v in r["counts"].items():
            row["counts"][k] = row["counts"].get(k, 0) + v
    return out


def dropped_spans() -> int:
    """Spans not recorded because the list held :data:`MAX_SPANS`."""
    return _dropped


def reset_spans() -> None:
    """Forget every record (open spans stay open, unrecorded)."""
    global _dropped
    _records.clear()
    _events.clear()
    _dropped = 0


_TRACES = itertools.count()


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the block with ``torch.profiler`` (CPU activities, plus
    CUDA activities when torch sees a card) and write a Chrome trace
    (``chrome://tracing``, Perfetto) into ``logdir`` on exit, and beside
    it the block's span report (:func:`span_report` as JSON, with the
    dropped count). Yields the profiler; its ``trace_path`` and
    ``span_report_path`` are set on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    first = len(_records)
    with profile(activities=activities) as prof:
        yield prof
    stem = os.path.join(logdir, f"trace_{os.getpid()}_{next(_TRACES)}")
    prof.trace_path = stem + ".json"
    prof.export_chrome_trace(prof.trace_path)
    prof.span_report_path = stem + ".spans.json"
    with open(prof.span_report_path, "w") as f:
        json.dump({"dropped": _dropped,
                   "spans": span_report(spans()[first:])}, f, indent=1)

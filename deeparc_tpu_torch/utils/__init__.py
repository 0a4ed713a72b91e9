"""Operational helpers: solver-state checkpoints, the JSONL logger, the
spans (``span``, ``spans``, ``span_report``, ``reset_spans``), the
profiler trace (``trace_to``) and the NaN-debug toggle
(``debug.set_nan_debugging`` / ``debug.nan_debugging``); the port of
``deeparc_tpu.utils``."""

from deeparc_tpu_torch.utils.checkpoint import (
    load_solver_state,
    save_solver_state,
)
from deeparc_tpu_torch.utils.logging import JsonlLogger
from deeparc_tpu_torch.utils.profiling import (
    reset_spans,
    span,
    span_report,
    spans,
    trace_to,
)

__all__ = ["JsonlLogger", "load_solver_state", "reset_spans",
           "save_solver_state", "span", "span_report", "spans", "trace_to"]

"""Operational helpers: solver-state checkpoints, the JSONL logger and the
phase timers (the port of ``deeparc_tpu.utils``, without its
``jax.profiler`` trace hook and its NaN-debug toggles)."""

from deeparc_tpu_torch.utils.checkpoint import (
    load_solver_state,
    save_solver_state,
)
from deeparc_tpu_torch.utils.logging import JsonlLogger
from deeparc_tpu_torch.utils.profiling import (
    phase_report,
    phase_timer,
    reset_phases,
)

__all__ = ["JsonlLogger", "load_solver_state", "phase_report", "phase_timer",
           "reset_phases", "save_solver_state"]

"""Structured per-iteration log lines (JSONL: cost, gradient norm,
trust-region radius, step quality), PyTorch port of
``deeparc_tpu.utils.logging``; the event lines are the reference
package's."""

from __future__ import annotations

import json
import time


class JsonlLogger:
    def __init__(self, path: str | None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self.t0 = time.time()

    def log(self, event: str, **fields) -> None:
        if self._fh is None:
            return
        rec = {"t": round(time.time() - self.t0, 3), "event": event, **fields}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def log_iteration(logger, k: int, info) -> None:
    """The ``lm_iteration`` line of one LM step (``StepInfo``), as every
    engine's driver writes it."""
    if logger is not None:
        logger.log("lm_iteration", iter=k, cost=float(info.cost),
                   cost_change=float(info.cost_change),
                   grad_max=float(info.grad_max),
                   step_norm=float(info.step_norm),
                   radius=float(info.radius), rho=float(info.rho),
                   accepted=bool(info.accepted))

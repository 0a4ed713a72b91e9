"""Numerical-debugging toggle, the port's counterpart of
``deeparc_tpu.utils.debug`` (``jax_debug_nans``).

The reference has no sanitizers (plain ``-W -Wall -O3``,
``CMakeLists.txt:2``). The JAX package's guard is ``jax_debug_nans``: a
jitted computation that returns a NaN raises ``FloatingPointError`` after
a re-run op by op names the primitive that produced it, e.g. the
unguarded perspective divide when a point crosses z = 0
(``src/snavely_reprojection_error.hh:49-50``). A NaN inside a ``where``
branch that is not taken does not trigger it.

The port checks at the same boundaries: the outputs of the reprojection
residual and cost functions, the state each engine's Python-driver LM
step returns, and under ``driver="while_loop"`` the state the driver
reads back between blocks (never inside a captured graph). On a NaN it
re-runs the failing call under a ``TorchDispatchMode`` that names the
first operator whose output holds a NaN that its inputs did not hold;
the hand kernels' wrappers (ctypes launches, not torch operators) report
their outputs to the same re-run (:func:`kernel_boundary`). Then it
raises ``FloatingPointError`` with that name, the engine and the
iteration.

Off (the default), it adds no operation and no host read: the
boundaries read one Python flag, :func:`enabled`, when a solve builds
its step or when a residual function is called.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_ENABLED = False
# > 0 inside a block of the on-device driver (its warm-up, capture and
# replays), where no check may read the device
_SUSPENDED = 0
# the re-run's dispatch mode, while one runs (kernel wrappers report to it)
_RERUN = None
# checks run (each one reads the device once): a test's probe that the
# toggle off costs nothing
checks = 0


def set_nan_debugging(enabled: bool = True) -> None:
    """Globally enable/disable the NaN checks (fail loudly on NaN)."""
    global _ENABLED
    _ENABLED = bool(enabled)


@contextlib.contextmanager
def nan_debugging(enabled: bool = True):
    """Scoped toggle (restores the previous value on exit)."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    try:
        yield
    finally:
        _ENABLED = prev


def enabled() -> bool:
    """True when the checks are on and not suspended."""
    return _ENABLED and not _SUSPENDED


@contextlib.contextmanager
def suspended():
    """No check inside (a block of the on-device driver)."""
    global _SUSPENDED
    _SUSPENDED += 1
    try:
        yield
    finally:
        _SUSPENDED -= 1


def _leaves(tree) -> list:
    # imported here: the solver imports this module
    from deeparc_tpu_torch.solver.device_loop import tree_leaves

    return tree_leaves(tree)


def _nan_count(tree) -> int:
    """NaNs in the floating tensors of ``tree`` (one host read)."""
    parts = [torch.isnan(t).sum() for t in _leaves(tree)
             if t.is_floating_point() and t.numel()]
    return int(torch.stack([p.to(parts[0].device) for p in parts]).sum()) \
        if parts else 0


def has_nan(tree) -> bool:
    global checks
    checks += 1
    return _nan_count(tree) > 0


# operators whose outputs hold no computed values (fresh storage may hold
# any bits, NaNs too)
_UNINITIALISED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "empty_permuted", "resize_")


class _FirstNaN(torch.utils._python_dispatch.TorchDispatchMode):
    """Names the first operator (or hand kernel) whose output holds a NaN
    that its inputs did not hold."""

    def __init__(self):
        super().__init__()
        self.found = None

    def note(self, name, inputs, outputs):
        if self.found is None and _nan_count(outputs) \
                and not _nan_count(inputs):
            self.found = name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.found is None \
                and func.overloadpacket.__name__ not in _UNINITIALISED:
            # an in-place or out= op's output aliases an input: what it
            # held before is gone, so it counts as written, not read
            written = {id(t) for t in _leaves(out)}
            ins = [t for t in _leaves((list(args), kwargs))
                   if id(t) not in written]
            self.note(str(func), ins, out)
        return out


def kernel_boundary(fn):
    """Wraps a hand-kernel wrapper so that a NaN re-run sees its outputs
    (a ctypes launch is no torch operator). Outside a re-run it is one
    Python test a call."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if _RERUN is not None:
            _RERUN.note(f"kernel {fn.__name__}", (list(args), kwargs), out)
        return out
    return wrapped


def first_nan_op(fn, *args):
    """Re-run ``fn(*args)`` op by op; the name of the first operator whose
    output holds a NaN its inputs did not hold, or None."""
    global _RERUN
    mode = _FirstNaN()
    prev, _RERUN = _RERUN, mode
    try:
        # the re-run's own boundaries check nothing
        with suspended(), torch.no_grad(), mode:
            fn(*args)
    finally:
        _RERUN = prev
    return mode.found


def _raise(name, where):
    origin = (f"first produced by {name}" if name else
              "no operator of the re-run produced it: its inputs held it")
    raise FloatingPointError(f"NaN in {where}: {origin}")


def check_call(fn, args, out, where: str):
    """Raise if ``out`` (of ``fn(*args)``) holds a NaN, naming its
    producer."""
    if has_nan(out):
        _raise(first_nan_op(fn, *args), where)
    return out


def checked_step(step, engine: str, reducer=None):
    """``step(state, *inputs) -> (state, info)`` with its returned state
    and info checked when the toggle is on (read once, here: a solve
    builds its step once), else ``step`` itself. Each call keeps a copy
    of its input state for the re-run (a fused-trial step writes into
    its state). With ``reducer`` (a sharded step) every rank learns
    whether any rank saw a NaN, and all re-run together."""
    if not enabled():
        return step
    from deeparc_tpu_torch.solver.device_loop import tree_map

    def run(state, *inputs):
        saved = tree_map(torch.clone, state)
        out = step(state, *inputs)
        bad = has_nan(out)
        if reducer is not None:
            bad = bool(reducer.max(torch.tensor(
                float(bad), dtype=torch.float64,
                device=_leaves(out)[0].device)) > 0)
        if bad:
            k = getattr(saved, "k", None)
            where = f"the {engine} LM step" + (
                f" of iteration {int(k) + 1}" if k is not None else "")
            _raise(first_nan_op(step, saved, *inputs), where)
        return out

    return run


def check_block(loop, saved, k0: int, k: int, engine: str, reducer=None):
    """After a block of the on-device driver (``BlockLoop``) that took the
    state from ``saved`` at iteration ``k0`` to iteration ``k``: raise if
    the state read back holds a NaN, naming the producer by re-running the
    block's steps of the ``engine`` from ``saved`` eagerly, op by op (the
    steps' device loops in their plain form, as the driver's warm-up runs
    them). With ``reducer`` every rank learns whether any saw a NaN, and
    all re-run every step (their collectives stay paired)."""
    bad = has_nan(loop.state)
    if reducer is not None:
        bad = bool(reducer.max(torch.tensor(
            float(bad), dtype=torch.float64,
            device=_leaves(loop.state)[0].device)) > 0)
    if not bad:
        return
    # imported here: the kernels import this module
    from deeparc_tpu_torch.kernels import graph_loop

    state, name, at = saved, None, k0 + 1
    for it in range(k0 + 1, max(k, k0 + 1) + 1):
        box = []
        with graph_loop.eager_loops():
            found = first_nan_op(
                lambda st: box.append(loop.step(st, *loop.inputs)), state)
        if name is None and found is not None:
            name, at = found, it
            if reducer is None:
                break
        state = box[0][0]
    _raise(name, f"the {engine} LM step of iteration {at} "
                 f"(driver='while_loop')")

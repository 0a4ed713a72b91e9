"""Bundle adjustment on the observation list (the indexed engine): LM trust
region over the Schur-eliminated scene, PyTorch port of
``deeparc_tpu.solver.ba``, and the solver records every engine shares.

The native replacement for the reference's ``solve()`` (``src/sfm.cc:31-75``,
DENSE_SCHUR, <= 100 iterations, 3600 s cap, progress to stdout): one step
function -- linearize (``vmap(jacfwd)``, ``residuals/reprojection.py``) ->
Schur solve (``solver/schur.py``) -> trial evaluation -> trust-region
update -- driven from Python with Ceres-style progress lines, the
wall-clock cap, periodic solver-state checkpoints and a JSONL logger.

Status codes: 0 running/max-iter, 2 function-tol, 3 gradient-tol,
4 parameter-tol, 5 trust region collapsed.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import NamedTuple

import torch

from deeparc_tpu_torch.config import SolverOptions
from deeparc_tpu_torch.scene import BAParams, SceneIndex
from deeparc_tpu_torch.solver import trust_region as tr_mod
from deeparc_tpu_torch.utils import debug
from deeparc_tpu_torch.utils.logging import log_iteration
from deeparc_tpu_torch.utils.profiling import span, traced

# the span (``utils/profiling.py``) of a solve's LM loop, under either
# driver, every engine
LM_LOOP = "deeparc.lm_loop"


class StepInfo(NamedTuple):
    cost: torch.Tensor
    cost_change: torch.Tensor
    grad_max: torch.Tensor
    step_norm: torch.Tensor
    radius: torch.Tensor
    rho: torch.Tensor
    accepted: torch.Tensor
    # PCG iterations the linear solve used (the tile engine's
    # ITERATIVE_SCHUR; -1 where the solve is direct)
    cg_iters: int = -1


class BAResult(NamedTuple):
    params: BAParams
    cost: float
    iterations: int
    status: int
    # wall-clock seconds of the LM loop (every step ends in a host sync)
    seconds: float = 0.0
    # PCG iterations over the solve (the tile engine's ITERATIVE_SCHUR)
    cg_iterations: int = 0


class BAState(NamedTuple):
    params: BAParams
    cost: torch.Tensor
    tr: tr_mod.TRState
    k: int
    status: torch.Tensor


def robust_cost(params: BAParams, index: SceneIndex,
                options: SolverOptions) -> torch.Tensor:
    """0.5 * sum rho(||r||^2), the robustified objective (the plain cost for
    the trivial loss, the reference's NULL loss at ``src/sfm.cc:48``)."""
    from deeparc_tpu_torch.residuals.reprojection import residuals
    from deeparc_tpu_torch.solver.loss import rho

    r = residuals(params, index)
    s = torch.sum(r * r, dim=-1)
    return 0.5 * torch.sum(rho(s, options.loss, options.loss_scale))


def _apply_step(params: BAParams, dp: torch.Tensor,
                dc: torch.Tensor) -> BAParams:
    from deeparc_tpu_torch.residuals.reprojection import (
        flatten_camera,
        unflatten_camera,
    )

    out = unflatten_camera(flatten_camera(params) + dc, params)
    return dataclasses.replace(out, points=params.points + dp)


def make_step_pure(options: SolverOptions, device_loop: bool = False):
    """The LM step as a function of its inputs only:
    ``step(state, index, cam_free, point_free, maps=None) ->
    (BAState, StepInfo)``. ``maps`` are the solve's fixed-order row-sum
    maps (``solver.schur.schur_maps`` of ``index``), which the card
    needs. ``device_loop=True`` (the ``while_loop`` driver) runs PCG as
    :func:`solver.linalg.pcg_device`."""
    from deeparc_tpu_torch.residuals.reprojection import (
        FlatObsJacobians,
        flatten_camera,
        jacobian_blocks_flat,
    )
    from deeparc_tpu_torch.solver.loss import weight
    from deeparc_tpu_torch.solver.schur import (
        build_system,
        j_times,
        solve_schur,
        sys_r,
    )

    def step(state: BAState, index: SceneIndex, cam_free, point_free,
             maps=None):
        params = state.params
        dev = params.points.device
        blocks = jacobian_blocks_flat(params, index)
        if options.loss != "trivial":
            s = torch.sum(blocks.r * blocks.r, dim=-1)
            w = weight(s, options.loss, options.loss_scale)[:, None]
            blocks = FlatObsJacobians(r=blocks.r * w, jp=blocks.jp * w,
                                      jc=blocks.jc * w)
        sys = build_system(blocks.r, blocks.jp, blocks.jc, index,
                           point_free.shape[0], params.ext_rot.shape[0],
                           params.center.shape[0], cam_free, point_free, maps)
        dp, dc = solve_schur(sys, state.tr.radius, options, device_loop)
        mcc = tr_mod.model_cost_change(j_times(sys, dp, dc).reshape(-1),
                                       sys_r(sys).reshape(-1))

        trial = _apply_step(params, dp, dc)
        new_cost = robust_cost(trial, index, options)
        rho = (state.cost - new_cost) / torch.clamp(mcc, min=1e-300)
        accept = (mcc > 0) & (rho > options.min_relative_decrease)
        tr_next = tr_mod.select(
            accept, tr_mod.step_accepted(state.tr, rho, options.max_radius),
            tr_mod.step_rejected(state.tr))
        params_next = BAParams(**{
            f.name: torch.where(accept, getattr(trial, f.name),
                                getattr(params, f.name))
            for f in dataclasses.fields(BAParams)})
        cost_next = torch.where(accept, new_cost, state.cost)

        grad_max = torch.maximum(torch.max(torch.abs(sys.g_c)),
                                 torch.max(torch.abs(sys.g_p)))
        step_norm = torch.sqrt(torch.sum(dp * dp) + torch.dot(dc, dc))
        cam = flatten_camera(params)
        x_norm = torch.sqrt(torch.sum(params.points * params.points)
                            + torch.dot(cam, cam))
        cost_change = state.cost - new_cost
        ftol = accept & (torch.abs(cost_change)
                         <= options.function_tolerance * state.cost)
        ptol = accept & (step_norm <= options.parameter_tolerance
                         * (x_norm + options.parameter_tolerance))
        gtol = grad_max <= options.gradient_tolerance
        radius_min = tr_next.radius <= options.min_radius
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        status = torch.where(gtol, 3, torch.where(ftol, 2, torch.where(
            ptol, 4, torch.where(radius_min, 5, zero))))
        next_state = BAState(params=params_next, cost=cost_next, tr=tr_next,
                             k=state.k + 1, status=status)
        info = StepInfo(cost=cost_next, cost_change=cost_change,
                        grad_max=grad_max, step_norm=step_norm,
                        radius=state.tr.radius, rho=rho, accepted=accept)
        return next_state, info

    return step


def make_step(index: SceneIndex, free: BAParams, options: SolverOptions,
              device_loop: bool = False):
    """The step closed over (index, freeze masks, the index's row-sum
    maps): ``step(state) -> (BAState, StepInfo)``; ``device_loop`` as for
    :func:`make_step_pure`."""
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.solver.schur import schur_maps

    step = make_step_pure(options, device_loop)
    cam_free, point_free = flatten_camera(free), free.points
    maps = schur_maps(index, point_free.shape[0], free.ext_rot.shape[0],
                      free.center.shape[0],
                      dense=options.linear_solver == "dense_schur")
    return lambda state: step(state, index, cam_free, point_free, maps)


def init_state(params: BAParams, index: SceneIndex,
               options: SolverOptions) -> BAState:
    dtype, dev = params.points.dtype, params.points.device
    return BAState(params=params, cost=robust_cost(params, index, options),
                   tr=tr_mod.init_tr(options.initial_radius, dtype, dev),
                   k=0, status=torch.zeros((), dtype=torch.int64,
                                           device=dev))


def print_header(k: int, cost, cg: bool = False) -> None:
    """The Ceres-style progress header and the start line."""
    print(f"{'iter':>4} {'cost':>14} {'cost_change':>12} {'|gradient|':>11}"
          f" {'tr_radius':>10} {'rho':>9} {'accept':>6}"
          + (f" {'cg':>4}" if cg else ""))
    print(f"{k:>4} {float(cost):>14.6e}")


def print_iteration(k: int, info: StepInfo, cg: bool = False) -> None:
    """One Ceres-style progress line."""
    print(f"{k:>4} {float(info.cost):>14.6e}"
          f" {float(info.cost_change):>12.4e}"
          f" {float(info.grad_max):>11.4e}"
          f" {float(info.radius):>10.3e} {float(info.rho):>9.3f}"
          f" {bool(info.accepted)!s:>6}"
          + (f" {info.cg_iters:>4}" if cg else ""))


def lm_running(status) -> bool:
    """The Python driver's read of the step's status (0: running), the
    host's wait for the card (span ``deeparc.lm.sync``)."""
    with span("deeparc.lm.sync"):
        return int(status) == 0


def load_checkpoint(path: str | None, resume: bool, template: BAParams):
    """(BAParams, scalars) of the checkpoint at ``path`` in the template's
    dtype and device when ``resume`` is set and the file exists, else
    None."""
    if not (resume and path and os.path.exists(path)):
        return None
    from deeparc_tpu_torch.utils.checkpoint import load_solver_state

    return load_solver_state(path, dtype=template.points.dtype,
                             device=template.points.device)


def tr_of(scal: dict, like: torch.Tensor) -> tr_mod.TRState:
    """The trust-region state of a checkpoint's scalars."""
    return tr_mod.TRState(
        radius=torch.tensor(scal["radius"], dtype=like.dtype,
                            device=like.device),
        decrease_factor=torch.tensor(scal["decrease_factor"],
                                     dtype=like.dtype, device=like.device))


def save_checkpoint(path: str, params: BAParams, tr: tr_mod.TRState, k: int,
                    cost) -> None:
    """The solver-state sidecar (points in original order)."""
    from deeparc_tpu_torch.utils.checkpoint import save_solver_state

    save_solver_state(path, params, float(tr.radius),
                      float(tr.decrease_factor), k, float(cost))


@traced("deeparc.solve")
def solve_ba(params: BAParams, index: SceneIndex, free: BAParams,
             options: SolverOptions = SolverOptions(),
             driver: str = "python", checkpoint_path: str | None = None,
             checkpoint_every: int = 10, resume: bool = False,
             logger=None) -> BAResult:
    """LM to convergence on the observation list. The row-sum maps are
    built once per solve.

    ``driver="python"``: one Python-driven step per iteration with
    Ceres-style progress lines, the wall-clock cap
    (``max_solver_time_in_seconds``, ``src/sfm.cc:71``), a solver-state
    checkpoint every ``checkpoint_every`` iterations (``resume=True``
    restarts from ``checkpoint_path`` with the saved trust-region state)
    and a ``JsonlLogger``. ``driver="while_loop"``: the whole solve, up to
    ``options.max_iterations``, with no host read until it ends (on the
    card one CUDA graph, ``solver/device_loop.py``); as in the reference,
    no wall-clock cap, no checkpoint, no progress lines or log."""
    if driver not in ("python", "while_loop"):
        raise ValueError(f"unknown driver {driver!r}")
    state = init_state(params, index, options)
    if driver == "while_loop":
        from deeparc_tpu_torch.solver.device_loop import BlockLoop, run_blocks

        loop = BlockLoop(make_step(index, free, options, device_loop=True),
                         ())
        loop.load(state)
        # one block, the whole solve: no wall-clock cap, no checkpoint
        k, status, _, seconds = run_blocks(
            loop, 0, options.max_iterations, max(options.max_iterations, 1),
            float("inf"), engine="indexed")
        return BAResult(params=loop.state.params, cost=float(loop.state.cost),
                        iterations=k, status=status, seconds=seconds)
    step = debug.checked_step(make_step(index, free, options), "indexed")
    ck = load_checkpoint(checkpoint_path, resume, params)
    if ck is not None:
        ck_params, scal = ck
        state = state._replace(params=ck_params,
                               cost=robust_cost(ck_params, index, options),
                               tr=tr_of(scal, params.points),
                               k=scal["iteration"])
    t0 = time.time()
    k = state.k
    if options.progress_to_stdout:
        print_header(k, state.cost)
    with span(LM_LOOP):
        while lm_running(state.status) and k < options.max_iterations:
            if time.time() - t0 > options.max_seconds:
                break
            with span("deeparc.lm.step"):
                state, info = step(state)
            k += 1
            if options.progress_to_stdout:
                print_iteration(k, info)
            log_iteration(logger, k, info)
            if checkpoint_path and k % checkpoint_every == 0:
                save_checkpoint(checkpoint_path, state.params, state.tr, k,
                                state.cost)
    return BAResult(params=state.params, cost=float(state.cost),
                    iterations=k, status=int(state.status),
                    seconds=time.time() - t0)

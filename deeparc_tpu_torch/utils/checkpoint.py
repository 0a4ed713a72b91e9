"""Solver-state checkpoint/restore, PyTorch port of
``deeparc_tpu.utils.checkpoint``.

The ``.deeparc`` file is the scene checkpoint (the reference's mid-pipeline
writes are restartable inputs, ``src/sfm.cc:130``); this adds the LM
solver-state sidecar (parameters, trust-region radius and decrease factor,
iteration, cost) as a plain ``.npz``, so an interrupted solve resumes from
the same trust-region state. The keys are the reference package's, so a
file written by either package loads in the other."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.scene import BAParams


def save_solver_state(path: str, params: BAParams, radius: float,
                      decrease_factor: float, iteration: int,
                      cost: float) -> None:
    np.savez(path, **{
        f.name: getattr(params, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(BAParams)},
        radius=radius, decrease_factor=decrease_factor,
        iteration=iteration, cost=cost)


def load_solver_state(path: str, dtype=torch.float64, device="cuda"):
    """Returns (BAParams on ``device``, dict of scalars)."""
    device = check_device(device)
    z = np.load(path)
    params = BAParams(**{
        f.name: torch.as_tensor(np.asarray(z[f.name]), dtype=dtype,
                                device=device)
        for f in dataclasses.fields(BAParams)})
    scalars = {
        "radius": float(z["radius"]),
        "decrease_factor": float(z["decrease_factor"]),
        "iteration": int(z["iteration"]),
        "cost": float(z["cost"]),
    }
    return params, scalars

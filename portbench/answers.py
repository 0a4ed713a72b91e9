"""What the entries share: the starting state as the judge sees it, the
program's and the reference's answers in one host form, and the free
masks of the pipeline's full bundle-adjustment round on both sides."""

from __future__ import annotations

import numpy as np

from portbench import reference as ref


def host(t) -> np.ndarray:
    return t.detach().to("cpu").double().numpy()


def cameras_of(params) -> np.ndarray:
    """The program's camera parameters, [ext rows (rot, t), intrinsics
    (center, focal, dist)] flattened as the reference orders them."""
    import torch

    ext = torch.cat([params.ext_rot, params.ext_trans], dim=1)
    intr = torch.cat([params.center, params.focal, params.dist], dim=1)
    return np.concatenate([host(ext).reshape(-1), host(intr).reshape(-1)])


def start_of(data, free_intrinsics=()) -> dict:
    """The starting points and cameras, and which camera parameters the
    full round frees (the extrinsic records but record 0, the gauge, and
    the intrinsics that ``free_intrinsics`` names)."""
    E = data.ext_rot.shape[0]
    ext = np.concatenate([np.concatenate([data.ext_rot, data.ext_trans], 1),
                          np.zeros((1, 6))])
    intr = np.concatenate([data.center, data.focal, data.dist], 1)
    ext_free = np.zeros((E + 1, 6), bool)
    ext_free[1:E] = True
    intr_free = np.zeros(intr.shape, bool)
    for name in free_intrinsics:
        intr_free[:, ref.INTRINSIC_COLUMNS[name]] = True
    intr_free[:, 3] &= data.focal_size != 1
    intr_free[:, 4] &= data.dist_size >= 1
    intr_free[:, 5] &= data.dist_size == 2
    return {"points": np.asarray(data.points, np.float64),
            "cameras": np.concatenate([ext.reshape(-1), intr.reshape(-1)]),
            "cameras_free": np.concatenate([ext_free.reshape(-1),
                                            intr_free.reshape(-1)]),
            "ext_rows": E + 1,
            "ext_free_rows": ext_free[:, 0].astype(np.int64),
            "intr_free": intr_free.astype(np.int64)}


def program_free(scene, cfg):
    """The program's free masks of the pipeline's full round
    (``freeze_masks(scene)``), with the intrinsics that the configuration's
    ``free_intrinsics`` names freed as the reference frees them."""
    import dataclasses

    import torch

    from deeparc_tpu_torch.scene import freeze_masks

    names = cfg.get("free_intrinsics", ())
    free = freeze_masks(scene, optimize_intrinsics=bool(names))
    if not names:
        return free
    keep = torch.zeros(6, dtype=free.center.dtype, device=free.center.device)
    for name in names:
        keep[list(ref.INTRINSIC_COLUMNS[name])] = 1.0
    return dataclasses.replace(free, center=free.center * keep[0:2],
                               focal=free.focal * keep[2:4],
                               dist=free.dist * keep[4:6])


def reference_solve(ctx, dtype) -> dict:
    """The reference's answer to the cell's solve: the full round's masks,
    from the benchmark's arrays."""
    import torch

    prob = ref.problem(ctx["data"], dtype, ctx["device"])
    alive = torch.ones(prob.points.shape[0], dtype=dtype,
                       device=ctx["device"])
    masks = ref.free_masks(prob, alive, False,
                           ctx["config"].get("free_intrinsics", ()))
    obs = torch.ones(prob.obs_point.shape[0], dtype=dtype,
                     device=ctx["device"])
    out = ref.solve(prob, prob.points, prob.ext, prob.intr, obs, *masks,
                    ref.Options.of(ctx["config"]["solver"]))
    return {"points": host(out.points),
            "cameras": host(ref.camera_vector(out.ext, out.intr)),
            "cost": out.cost, "iterations": out.iterations}


def obs_keys(point, arc, ring, n_ring: int, n_arc: int) -> np.ndarray:
    """One int64 key per observation: (point, arc, ring); without sharing
    (ring size 0) the columns are (intrinsic, extrinsic), each below
    ``n_arc``."""
    width = n_ring or n_arc
    return ((point.astype(np.int64) * n_arc + arc.astype(np.int64)) * width
            + ring.astype(np.int64))

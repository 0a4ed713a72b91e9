"""Time the pieces of the grid engine's torch linearize (``impl="planes"``
/ ``"einsum"``: the monolithic kernels' plain versions) at one chunk of
points.

    python -m deeparc_tpu_torch.scripts.profile_planes [--n-points 8192]
    python -m deeparc_tpu_torch.scripts.profile_planes --device cpu \\
        --n-points 512                         # small

The counterpart of the reference's ``scripts/profile_planes.py`` and
``scripts/profile_assemble.py``, whose two XLA bodies the port runs as one
torch path. The rig is ``make_grid_rig_device``'s uniform one (8 x 24
cells, visibility 10/192, seed 0, float64) at 8192 points (the
reference's chunk), the pipeline's full-BA free mask, the plane stack a
solve builds once. ``linearize_grid_plain`` works through chunks of 256-point
tiles (``kernels/rig_grid.py``); each key below is its piece over all
chunks, timed alone (median of ``--reps`` runs, CUDA events on the card),
named after the reference's key where the piece computes the same thing:

  chain_ms            the residual chain (``_chain``): no reference key
  jacobians_ms        residuals and Jacobian planes (``_slot_products``
                      through ``_chunk_products``), as profile_assemble's
  point_side_ms       g_p, H_pp (``_point_side``), as both scripts'
  cam_grad_ms         the slot gradient (``_slot_grad``), as
                      profile_assemble's
  hcc_ms              the slot Gram (``_slot_gram``), as profile_assemble's
  slot_bin_ms         the slot rows into the cell table (``_bin_slots``,
                      ``_fold_slots``): no reference key
  cam_gram_ms         cam_grad + hcc + slot_bin in one run, as
                      profile_planes' (g_slots, hcc_slots)
  E_ms                the E rows (``_e_rows``), as profile_assemble's E_ms
                      and profile_planes' E_only_ms
  linearize_full_ms   ``linearize_grid_plain`` whole, as profile_planes'
  bin_slot_system_ms  ``solver.rig_grid._bin_slot_system``: no reference key
  flat_columns_ms     ``solver.rig_grid._flat_columns``: no reference key
  cost_only_ms        ``cost_grid_plain``, as profile_planes'

The reference's keys without a counterpart: profile_planes' pieces ran the
whole linearize and kept one output each (XLA dropped the rest), which a
torch path does not do, so its point_side / cam_gram / E_only are here the
pieces themselves; ``grid_jacobians`` and ``_cam_groups`` of
profile_assemble were left out of the port with the reference's
``GridBlocks`` layout (the plain versions build the planes in place). The
pieces' sum stands beside the whole. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.scripts import card_fields, time_ms

CHUNK_POINTS = 8192
BLOCK_NP = 256
LOSS, LOSS_SCALE = "trivial", 0.5


def setup(n_points: int, device):
    """(linearize arguments, plane stack, the kernels' prep of both): the
    rig and its monolithic plane stack, as the torch path's solve builds
    them."""
    from deeparc_tpu_torch.kernels.rig_grid import _prep_linearize_mono
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scripts.profile_grid import grid_free, rig
    from deeparc_tpu_torch.solver.rig_grid import (
        mono_stack,
        slot_free,
        slot_params,
    )

    params, grid = rig(n_points, None, device)
    free = grid_free(params)
    args = (params.points, free.points, slot_params(params, grid), grid,
            *slot_free(flatten_camera(free), grid))
    pxm = mono_stack(grid, (BLOCK_NP, 1024))
    return args, pxm, _prep_linearize_mono(*args, BLOCK_NP, pxm)


def chains(prep):
    """The residual chain of every chunk of tiles."""
    from deeparc_tpu_torch.kernels.rig_grid import _chain, _tile_chunks

    tbl, pts, bn = prep["tables"][0], prep["pts"], prep["block_np"]
    out = []
    for rows, planes, p0, p1 in _tile_chunks(prep["groups"], prep["pxms"],
                                             prep["starts"], bn):
        tb = tbl[rows]
        X = [pts[a, p0:p1].reshape(rows.shape[0], 1, bn) for a in range(3)]
        out.append(_chain(lambda c: tb[..., c:c + 1], X, planes[0],
                          planes[1], planes[2]))
    return out


def run(device="cuda", n_points: int = CHUNK_POINTS, reps: int = 5) -> dict:
    """The measurement as a dict (the JSON line's fields)."""
    from deeparc_tpu_torch.kernels import rig_grid as k
    from deeparc_tpu_torch.solver.rig_grid import (
        _bin_slot_system,
        _flat_columns,
    )

    dev = check_device(device)
    args, pxm, prep = setup(n_points, dev)
    grid = args[3]
    T, t_pad, t_ext = prep["T"], prep["t_pad"], prep["tables"][0].shape[0]
    R, K = grid.onehot_outer.shape[1], grid.onehot_intr.shape[1]
    t = lambda fn: time_ms(fn, reps, dev)
    chunks = list(k._chunk_products(prep, LOSS, LOSS_SCALE))
    grads = [k._slot_grad(c[5], c[6], c[1], c[2]) for c in chunks]
    grams = [k._slot_gram(c[5], c[6]) for c in chunks]

    def slot_bin():
        ghs = sum(k._bin_slots(g, h, c[7], t_ext)
                  for g, h, c in zip(grads, grams, chunks))
        return k._fold_slots(ghs, T, t_pad, grads[0].shape[0])

    def cam_gram():
        ghs = sum(k._bin_slots(k._slot_grad(c[5], c[6], c[1], c[2]),
                               k._slot_gram(c[5], c[6]), c[7], t_ext)
                  for c in chunks)
        return k._fold_slots(ghs, T, t_pad, grads[0].shape[0])

    res = {
        "chain_ms": t(lambda: chains(prep)),
        "jacobians_ms": t(lambda: list(k._chunk_products(prep, LOSS,
                                                         LOSS_SCALE))),
        "point_side_ms": t(lambda: [k._point_side(c[3], c[4], c[1], c[2])
                                    for c in chunks]),
        "cam_grad_ms": t(lambda: [k._slot_grad(c[5], c[6], c[1], c[2])
                                  for c in chunks]),
        "hcc_ms": t(lambda: [k._slot_gram(c[5], c[6]) for c in chunks]),
        "slot_bin_ms": t(slot_bin),
        "cam_gram_ms": t(cam_gram),
        "E_ms": t(lambda: [k._e_rows(c[3], c[4], c[5], c[6], prep["tables"],
                                     c[7], prep["intr_frozen"])
                           for c in chunks]),
    }
    del grads, grams, chunks
    res["linearize_full_ms"] = t(lambda: k.linearize_grid_plain(
        *args, loss=LOSS, loss_scale=LOSS_SCALE, block_np=BLOCK_NP, pxm=pxm))
    _, _, _, g_slots, hcc_slots, E = k.linearize_grid_plain(
        *args, block_np=BLOCK_NP, pxm=pxm)
    res["pieces_sum_ms"] = (res["jacobians_ms"] + res["point_side_ms"]
                            + res["cam_gram_ms"] + res["E_ms"])
    C = 6 * (R + K)
    res["bin_slot_system_ms"] = t(lambda: _bin_slot_system(
        g_slots, hcc_slots, grid, C, E.dtype))
    res["flat_columns_ms"] = t(lambda: _flat_columns(E, R, K))
    res["cost_only_ms"] = t(lambda: k.cost_grid_plain(
        args[0], args[2], grid, block_np=1024, pxm=pxm))
    res.update(card_fields(dev), n_points=n_points, n_cells=T,
               n_obs_alive=int(grid.mask.sum()), block_np=BLOCK_NP,
               n_chunks=sum(1 for _ in k._tile_chunks(
                   prep["groups"], prep["pxms"], prep["starts"], BLOCK_NP)),
               dtype="float64", reps=reps)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--n-points", type=int, default=CHUNK_POINTS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.n_points, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

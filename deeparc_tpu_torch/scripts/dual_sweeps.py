"""Time the reference's camera-major dual sweeps (``impl="dual"`` of
``deeparc_tpu.solver.tiles``), which the port's tile solver leaves out,
against the tile engine's hand sweep kernels.

    python -m deeparc_tpu_torch.scripts.dual_sweeps [--n-points N]
    python -m deeparc_tpu_torch.scripts.dual_sweeps --device cpu \\
        --n-points 2000                        # plain versions, small

The windowed BAL scene of ``chip_smoke.py``'s phase 6 (2000 cameras, 1M
points, 8 observations a point, float64; ``--n-points`` cuts it) is laid
out with locality and linearized once. The dual layout is the reference's
(:func:`cam_layout`, a numpy build on the host): every cell's live slots
as dense rows of one cell each, so the system binning and the sweeps'
camera side are row reduces and only two values a slot move between the
layouts in a sweep; its row sums into the cells run through the fixed-order
``sum_rows`` kernel. Each time is the median of 5 runs (CUDA events): the
dual path's per-step parts (the camera-major copy of j_cam, the system
binning) and sweeps (rhs, one matvec, edot), then the kernel path's
set-up (planes, sorted copies) and sweeps; a 30-PCG step's sweeps are
set-up + rhs + edot + 30 matvecs. The dual matvec, rhs and edot must agree
with the kernel path's within 1e-9 relative. The dual matvec's bound
reads the camera-major copy twice. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.kernels.tile import gather_map, sum_rows
from deeparc_tpu_torch.scripts import HBM_BYTES_PER_S, card_fields, time_ms

TILE_POINTS = 1_000_000
TILE_SCENE = dict(n_cameras=2000, track_length=8, window=128, n_hubs=8,
                  hub_frac=0.15, pixel_noise=1.0, point_noise=0.02)
PCG_ITERATIONS = 30
REPS = 5
# the dual sweeps against the kernel sweeps: the same products summed in
# other orders
RTOL = 1e-9


def cam_layout(tiles, min_width: int = 8, max_width: int = 2048):
    """The reference's camera-major layout of ``tiles``: a list of
    (row_cell (R,), slot_idx (R, S), row map) per row width S, and
    ``pm_src`` (M_flat,).

    The point-major flat slot order is the concatenation of every bucket's
    (Nb, W) slots; M_flat, one past the last, is the sentinel, which
    gathers a zero row. Each cell's live slots, in flat order, become one
    dense row (split across rows of ``max_width`` when the cell has more;
    the rest padded with the sentinel to the next power of two, at least
    ``min_width``). ``pm_src`` is the inverse map: a slot's position in the
    camera-major flat order (the rows, width by width), the sentinel there
    for dead slots. The row map is :func:`kernels.tile.gather_map`'s."""
    V = int(tiles.cells.slot_outer.shape[0])
    dev = tiles.row_of_point.device
    as_np = lambda t: t.detach().cpu().numpy()
    cells_flat = np.concatenate([as_np(b.cell).reshape(-1)
                                 for b in tiles.buckets])
    live = np.concatenate([as_np(b.mask).reshape(-1) > 0.5
                           for b in tiles.buckets])
    m_flat = cells_flat.shape[0]
    slot_ids = np.nonzero(live)[0].astype(np.int64)
    slot_sorted = slot_ids[np.argsort(cells_flat[slot_ids], kind="stable")]
    counts = np.bincount(cells_flat[slot_ids], minlength=V)
    starts = np.concatenate([[0], np.cumsum(counts)])
    by_width: dict = {}          # S -> (list[cell id], list[(S,) slot rows])
    for v in np.nonzero(counts)[0]:
        sl = slot_sorted[starts[v]: starts[v + 1]]
        while sl.size:
            take = sl[:max_width]
            S = max(min_width, 1 << (take.size - 1).bit_length())
            row = np.full(S, m_flat, np.int64)
            row[:take.size] = take
            rc, rows = by_width.setdefault(S, ([], []))
            rc.append(v)
            rows.append(row)
            sl = sl[max_width:]
    pm_src = np.full(m_flat, -1, np.int64)
    buckets, off = [], 0
    for S in sorted(by_width):
        rc, rows = by_width[S]
        rows = np.stack(rows)
        flat = rows.reshape(-1)
        valid = flat < m_flat
        pm_src[flat[valid]] = off + np.nonzero(valid)[0]
        row_cell = torch.as_tensor(np.asarray(rc, np.int32), device=dev)
        buckets.append((row_cell,
                        torch.as_tensor(rows.astype(np.int32), device=dev),
                        gather_map(row_cell, V)))
        off += rows.size
    pm_src[pm_src < 0] = off
    return buckets, torch.as_tensor(pm_src.astype(np.int32), device=dev)


def _take(src, idx):
    """``src[idx]`` for an int32 index tensor of any shape."""
    return torch.index_select(src, 0, idx.reshape(-1)).reshape(
        idx.shape + src.shape[1:])


def _take2(src, idx):
    """:func:`_take` of rows of two values, each row moved as one complex
    element (torch's gather of two-value rows runs far below the memory
    rate on the card, its gather of single elements does not)."""
    return torch.view_as_real(_take(torch.view_as_complex(src), idx))


def _pad_flat(parts):
    """The flat rows of ``parts`` and the sentinel's zero row."""
    parts = list(parts)
    return torch.cat(parts + [torch.zeros_like(parts[0][:1])])


def _row_dot(x, jc):
    """(R, 18): sum over a row's slots of x (R, S, 2) times J_cam."""
    return torch.bmm(x.reshape(x.shape[0], 1, -1),
                     jc.reshape(jc.shape[0], -1, 18))[:, 0]


def dual_prep(layout, sys):
    """Camera-major copies of the step's j_cam, one per row width."""
    jcam = _pad_flat(blk.j_cam.reshape(-1, 2, 18) for blk in sys.blocks)
    return tuple(_take(jcam, idx) for _, idx, _ in layout[0])


def dual_bin_system(layout, sys, cms, V):
    """g_cells (V, 18) and the cells' packed Grams (V, 171), binned
    through the camera-major rows."""
    from deeparc_tpu_torch.solver.tiles import _sym_pack

    r = _pad_flat(blk.r.reshape(-1, 2) for blk in sys.blocks)
    g = h = 0.0
    for (cell, idx, rows), jc in zip(layout[0], cms):
        j = jc.reshape(jc.shape[0], -1, 18)
        g = g + sum_rows(_row_dot(_take2(r, idx), jc), cell, V, rows)
        h = h + sum_rows(_sym_pack(torch.bmm(j.transpose(1, 2), j)), cell,
                         V, rows)
    return g, h


def _pass_t(layout, cms, v_cells):
    """t = J_cam v per slot, in point-major flat order (M_flat, 2)."""
    parts = [torch.bmm(jc.reshape(jc.shape[0], -1, 18),
                       _take(v_cells, cell)[:, :, None]).reshape(-1, 2)
             for (cell, _, _), jc in zip(layout[0], cms)]
    return _take2(_pad_flat(parts), layout[1])


def dual_sweep(layout, sys, binv, cms, v_cells, rhs_mode):
    """E^T B^-1 g_p (rhs_mode) or E^T B^-1 E v, binned to (V, 18)."""
    V = sys.hcc_cells.shape[0]
    t = None if rhs_mode else _pass_t(layout, cms, v_cells)
    t2, off_pt, off_slot = [], 0, 0
    for blk in sys.blocks:
        Nb, W = blk.j_x.shape[:2]
        if rhs_mode:
            ev = sys.g_p[off_pt:off_pt + Nb]
        else:
            t_b = t[off_slot:off_slot + Nb * W].reshape(Nb, W, 2, 1)
            ev = torch.sum(blk.j_x * t_b, dim=(1, 2))
        w = torch.sum(binv[off_pt:off_pt + Nb] * ev[:, None, :], dim=-1)
        t2.append(torch.sum(blk.j_x * w[:, None, None, :], dim=-1)
                  .reshape(-1, 2))
        off_pt += Nb
        off_slot += Nb * W
    t2 = _pad_flat([torch.cat(t2)])
    out = 0.0
    for (cell, idx, rows), jc in zip(layout[0], cms):
        out = out + sum_rows(_row_dot(_take2(t2, idx), jc), cell, V, rows)
    return out


def dual_edot(layout, sys, cms, v_cells):
    """(E v) per point row (Nrows, 3)."""
    t = _pass_t(layout, cms, v_cells)
    parts, off_slot = [], 0
    for blk in sys.blocks:
        Nb, W = blk.j_x.shape[:2]
        t_b = t[off_slot:off_slot + Nb * W].reshape(Nb, W, 2, 1)
        parts.append(torch.sum(blk.j_x * t_b, dim=(1, 2)))
        off_slot += Nb * W
    out = torch.zeros_like(sys.g_p)
    n = sum(p.shape[0] for p in parts)
    out[:n] = torch.cat(parts)
    return out


def _rel(a, b) -> float:
    scale = float(torch.max(torch.abs(b)))
    return float(torch.max(torch.abs(a - b))) / scale if scale else 0.0


def run(device: str = "cuda", n_points: int = TILE_POINTS) -> dict:
    from deeparc_tpu_torch.io import make_bal_windowed_host
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.linalg import inv3x3
    from deeparc_tpu_torch.solver.rig_grid import slot_params
    from deeparc_tpu_torch.solver.tiles import (
        _make_kernel_sweeps,
        linearize_tiles,
        linearize_tiles_mixed,
        pack_cells,
        tiles_from_scene,
    )

    dev = check_device(device)
    data = make_bal_windowed_host(n_points=n_points, seed=0, **TILE_SCENE)
    scene = from_deeparc(data, dtype=torch.float64, device=dev)
    free = freeze_masks(scene)
    tiles, params_t, free_t = tiles_from_scene(scene, free)
    cam_free = flatten_camera(free)
    C, V = cam_free.numel(), tiles.cells.cols.shape[0]
    packed = pack_cells(slot_params(params_t, tiles.cells), tiles.cells,
                        cam_free)
    t0 = time.time()
    layout = cam_layout(tiles)
    layout_s = time.time() - t0
    sys = linearize_tiles(params_t.points, packed, tiles, free_t, C)
    ksys, planes = linearize_tiles_mixed(params_t.points, packed, tiles,
                                         free_t, C)
    eye = torch.eye(3, dtype=sys.hpp.dtype, device=dev)
    binv = inv3x3(sys.hpp + eye)
    v = torch.randn((V, 18), dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    t = lambda fn: time_ms(fn, REPS, dev)

    cms = dual_prep(layout, sys)
    dual = {"prep": t(lambda: dual_prep(layout, sys)),
            "system binning": t(lambda: dual_bin_system(layout, sys, cms, V)),
            "rhs": t(lambda: dual_sweep(layout, sys, binv, cms, None, True)),
            "matvec": t(lambda: dual_sweep(layout, sys, binv, cms, v,
                                           False)),
            "edot": t(lambda: dual_edot(layout, sys, cms, v))}
    setup = lambda: _make_kernel_sweeps(tiles, ksys, binv, planes, None, 256)
    sweep, edot = setup()
    kern = {"set-up": t(setup),
            "rhs": t(lambda: sweep(None, True)),
            "matvec": t(lambda: sweep(v, False)),
            "edot": t(lambda: edot(v))}
    errs = {"rhs": _rel(dual_sweep(layout, sys, binv, cms, None, True),
                        sweep(None, True)),
            "matvec": _rel(dual_sweep(layout, sys, binv, cms, v, False),
                           sweep(v, False)),
            "edot": _rel(dual_edot(layout, sys, cms, v), edot(v))}
    if not max(errs.values()) <= RTOL:
        raise AssertionError(f"the dual sweeps stray from the kernel "
                             f"path's: {errs}")
    n = PCG_ITERATIONS
    jcam_bytes = sum(c.numel() * c.element_size() for c in cms)
    return dict(
        card_fields(dev), n_points=n_points,
        live_slots=int(sum(float(b.mask.sum()) for b in tiles.buckets)),
        camera_major_slots=sum(idx.numel() for _, idx, _ in layout[0]),
        rows_by_width={int(idx.shape[1]): int(idx.shape[0])
                       for _, idx, _ in layout[0]},
        layout_host_s=layout_s, dual_ms=dual, kernel_ms=kern,
        sweeps_per_step_ms={
            "dual": dual["prep"] + dual["rhs"] + dual["edot"]
            + n * dual["matvec"],
            "kernels": kern["set-up"] + kern["rhs"] + kern["edot"]
            + n * kern["matvec"]},
        dual_matvec_bound_ms=2 * jcam_bytes / HBM_BYTES_PER_S * 1e3,
        rel_err_to_kernels=errs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--n-points", type=int, default=TILE_POINTS,
                    help="points of the windowed BAL scene (cut only this)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.n_points)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

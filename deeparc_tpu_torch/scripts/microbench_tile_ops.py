"""Price every way to read and write the tile engine's cell-space vectors
per observation slot at BAL scale.

    python -m deeparc_tpu_torch.scripts.microbench_tile_ops [--m 8388608] \\
        [--v 2000] [--w 8] [--dtype float32]
    python -m deeparc_tpu_torch.scripts.microbench_tile_ops --device cpu \\
        --m 16384 --v 64                      # small

The counterpart of the reference's ``scripts/microbench_tile_ops.py``. A
PCG sweep reads an 18-wide cell-space vector per slot, does its einsum
work, and bins an 18-wide contribution back: M slots (rounded up to 8192)
in rows of W, V cells, values in ``--dtype`` (float32, the reference's, by
default), seed 0. The candidates are the reference's: reads (gather and
``index_select`` of 18- and 78-wide rows, the one-hot read, the
row-broadcast read), the point-major <-> camera-major permute gathers,
writes (one-hot binning, scatter-add by ``index_add_``, the sorted
segment sum by ``segment_reduce``, the within-row reduce, scatter-add of
rows) and the two J_cam einsums of the payload; plus ``sum_rows``
(``kernels/tile.py``, its ``gather_map`` cut at 512 sources a segment),
the port's fixed-order write. They are torch library calls: none stands
in for a kernel of the port but ``sum_rows``. Rows and their shares as in
``microbench_ops``; a share above 1.05 raises. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.scripts import card_fields, launch_counts, nbytes
from deeparc_tpu_torch.scripts.microbench_ops import (
    CHUNK,
    DTYPES,
    SEGMENT,
    Candidate,
    measure,
    onehot_bin,
    onehot_cands,
    onehot_read,
)


def candidates(M, V, W, dtype, device, seed=0):
    """The rows of the scan (module docstring); M a multiple of 8192."""
    from deeparc_tpu_torch.kernels.tile import gather_map, sum_rows

    gen = torch.Generator(device=device).manual_seed(seed)
    normal = lambda *shape: torch.randn(shape, generator=gen, dtype=dtype,
                                        device=device)
    R = M // W
    cell = torch.randint(0, V, (M,), generator=gen,
                         device=device).to(torch.int32)
    table18, table78 = normal(V, 18), normal(V, 78)
    u18, u2 = normal(M, 18), normal(M, 2)
    perm = torch.randperm(M, generator=gen, device=device).to(torch.int32)
    rows18 = u18.reshape(R, W, 18)
    cell_r = cell.reshape(R, W)[:, 0].contiguous()
    cell_sorted = torch.sort(cell).values
    lengths = torch.bincount(cell_sorted, minlength=V)
    cell_map = gather_map(cell, V, SEGMENT)
    cell_small, u_small = cell[:R], u18[:R]
    jcam, vsl = normal(R, W, 2, 18), normal(R, W, 18)
    t2 = normal(R, W, 2)
    esz = u18.element_size()
    zeros = lambda: torch.zeros((V, 18), dtype=dtype, device=device)
    cands = [
        # the read direction: a cell-space row per slot
        Candidate("gather (M,18) <- (V,18)", lambda: table18[cell],
                  nbytes(table18, cell) + M * 18 * esz,
                  check=("take", table18, cell)),
        Candidate("gather (M,78) <- (V,78)", lambda: table78[cell],
                  nbytes(table78, cell) + M * 78 * esz,
                  check=("take", table78, cell)),
        Candidate("index_select (M,18) <- (V,18)",
                  lambda: torch.index_select(table18, 0, cell),
                  nbytes(table18, cell) + M * 18 * esz,
                  check=("take", table18, cell)),
    ]
    cands += onehot_cands("one-hot read (M,18), 8k chunks",
                          lambda d: onehot_read(table18, cell, d), table18,
                          cell, V, ("take", table18, cell), M, dtype)
    cands += [
        # one cell per row of W slots (the camera-major pattern)
        Candidate("row-broadcast read (R,18)[row_cell]",
                  lambda: table18[cell_r],
                  nbytes(table18, cell_r) + R * 18 * esz,
                  check=("take", table18, cell_r)),
        # point-major <-> camera-major intermediates
        Candidate("permute gather (M,2)", lambda: u2[perm],
                  nbytes(u2, perm) + M * 2 * esz, check=("take", u2, perm)),
        Candidate("permute gather (M,18)", lambda: u18[perm],
                  nbytes(u18, perm) + M * 18 * esz,
                  check=("take", u18, perm)),
    ]
    # the write direction: bin (M, 18) into (V, 18)
    cands += onehot_cands("one-hot bin (M,18)->(V,18), 8k chunks",
                          lambda d: onehot_bin(u18, cell, V, d), u18, cell,
                          V, ("add_at", u18, cell, V), V, dtype)
    cands += [
        Candidate("scatter-add (M,18)->(V,18)",
                  lambda: zeros().index_add_(0, cell, u18),
                  nbytes(u18, cell) + V * 18 * esz,
                  check=("add_at", u18, cell, V)),
        Candidate("segment-sum sorted (M,18)->(V,18)",
                  lambda: torch.segment_reduce(u18, "sum", lengths=lengths),
                  nbytes(u18, lengths) + V * 18 * esz,
                  check=("add_at", u18, cell_sorted, V)),
        Candidate("sum_rows (M,18)->(V,18)",
                  lambda: sum_rows(u18, cell, V, cell_map),
                  nbytes(u18, *cell_map) + V * 18 * esz,
                  check=("add_at", u18, cell, V)),
        Candidate("within-row reduce (R,W,18)->(R,18)",
                  lambda: rows18.sum(dim=1), nbytes(u18) + R * 18 * esz,
                  check=("add_at", u18, torch.arange(M, device=device) // W,
                         R)),
        Candidate("scatter-add rows (R,18)->(V,18)",
                  lambda: zeros().index_add_(0, cell_small, u_small),
                  nbytes(u_small, cell_small) + V * 18 * esz,
                  check=("add_at", u_small, cell_small, V)),
        # the payload's einsums at M scale
        Candidate("einsum rwkc,rwc->rwk (J_cam . v)",
                  lambda: torch.einsum("rwkc,rwc->rwk", jcam, vsl),
                  M * (36 + 18 + 2) * esz, 2.0 * M * 36,
                  str(dtype).replace("torch.", "")),
        Candidate("einsum rwkc,rwk->rwc (J_cam^T t)",
                  lambda: torch.einsum("rwkc,rwk->rwc", jcam, t2),
                  M * (36 + 2 + 18) * esz, 2.0 * M * 36,
                  str(dtype).replace("torch.", "")),
    ]
    return cands


def run(device="cuda", M=8_388_608, V=2000, W=8, dtype="float32",
        reps: int = 5) -> dict:
    """The scan as a dict (the JSON line's fields)."""
    from deeparc_tpu_torch.kernels import reset_launch_counts

    dev = check_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    M = -(-M // CHUNK) * CHUNK
    reset_launch_counts()
    rows = measure(candidates(M, V, W, DTYPES[dtype], dev), reps, dev)
    return dict(card_fields(dev), M=M, V=V, W=W, dtype=dtype, reps=reps,
                rows=rows, launches={"sum_rows": launch_counts()["sum_rows"]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--m", type=int, default=8_388_608)
    ap.add_argument("--v", type=int, default=2000)
    ap.add_argument("--w", type=int, default=8)
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.m, args.v, args.w, args.dtype,
                         args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

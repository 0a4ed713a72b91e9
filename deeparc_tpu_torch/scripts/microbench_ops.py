"""Price the memory primitives the general-sparsity (BAL) layout was chosen
from: gather, sorted and unsorted segment sums, the port's fixed-order
row sum, one-hot binning and lookup, row and plane reductions, and two
compute anchors.

    python -m deeparc_tpu_torch.scripts.microbench_ops [--m 4000000] \\
        [--n 400000] [--c 2048] [--w 16] [--dtype float32]
    python -m deeparc_tpu_torch.scripts.microbench_ops --device cpu \\
        --m 20000 --n 2000 --c 64             # small

The counterpart of the reference's ``scripts/microbench_ops.py``, whose
TPU numbers chose the tile layout (``solver/tiles.py``). M values (M, 16)
in ``--dtype`` (float32, the reference's, by default), N segments for
the sorted keys (point ids), C cells for the unsorted ones (camera ids),
W-wide rows for the row reduction; data from seed 0. These are torch
library calls: what they price is the library on this device, and none
stands in for a kernel of the port, apart from ``sum_rows``
(``kernels/tile.py``, through its ``gather_map`` cut at 512 sources a
segment, as the tile solver builds it), the port's own fixed-order write.

Every row is the median of ``--reps`` runs (CUDA events on the card), the
bytes it must move (each input read once, its output written once) and
their share of the 3.35 TB/s memory rate; the one-hot products, the FMA
chain and the 8192^3 bf16 matmul also give their operations' share of the
data-sheet peak for their type (bf16 on the tensor cores; float32 and
float64 outside them, TF32 off). A share above 1.05 raises (a count
error). One-hot products run over 8192-row chunks, as the reference's
``lax.map`` did. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, NamedTuple

import torch

from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.scripts import (
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    card_fields,
    check_share,
    launch_counts,
    nbytes,
    time_ms,
)

CHUNK = 8192
# the tile solver's segment of a long row sum (solver/tiles.py
# _PIECE_SEGMENT)
SEGMENT = 512
DTYPES = {"float32": torch.float32, "float64": torch.float64}
MATMUL_N = 8192


class Candidate(NamedTuple):
    """One row: ``fn()`` computes it; ``moved`` bytes, ``ops`` operations
    of type ``ops_dtype``; ``check`` the numpy reference of its output
    (("take", src, idx), ("add_at", vals, idx, n_out)) or None."""

    name: str
    fn: Callable
    moved: int
    ops: float = 0.0
    ops_dtype: str = ""
    check: tuple | None = None


def onehot_bin(vals, ids, n_out, dtype):
    """sum over rows of one_hot(ids) (n_out,) x vals, by ``torch.matmul``
    over chunks of 8192 rows in ``dtype`` (accumulated in float32 for
    bf16), summed in the values' dtype."""
    out = torch.zeros((n_out, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    cols = torch.arange(n_out, device=vals.device)
    for lo in range(0, vals.shape[0], CHUNK):
        oh = (ids[lo:lo + CHUNK, None] == cols).to(dtype)
        out += torch.matmul(oh.T, vals[lo:lo + CHUNK].to(dtype)).to(out.dtype)
    return out


def onehot_read(table, ids, dtype):
    """table[ids] as one_hot(ids) x table by ``torch.matmul`` over chunks
    of 8192 rows in ``dtype``."""
    cols = torch.arange(table.shape[0], device=table.device)
    t = table.to(dtype)
    return torch.cat([torch.matmul((ids[lo:lo + CHUNK, None] == cols)
                                   .to(dtype), t)
                      for lo in range(0, ids.shape[0], CHUNK)])


def onehot_cands(label, fn_of, vals_or_table, ids, n_out, check, rows_out,
                 work_dtype):
    """The one-hot rows of both dtypes: the working one and bf16."""
    out = []
    for name, dt, peak in ((str(work_dtype).replace("torch.", ""),
                            work_dtype, None),
                           ("bf16", torch.bfloat16, "bfloat16")):
        cols = vals_or_table.shape[1]
        moved = (nbytes(vals_or_table, ids)
                 + rows_out * cols * vals_or_table.element_size())
        flops = 2.0 * ids.shape[0] * n_out * cols
        out.append(Candidate(
            f"{label}_{name}", (lambda d=dt: fn_of(d)), moved, flops,
            peak or name, check))
    return out


def fma8(x):
    """Eight steps of x * 1.0001 + 0.1 in torch ops (two passes a step)."""
    for _ in range(8):
        x = x * 1.0001 + 0.1
    return x


def candidates(M, N, C, W, dtype, device, seed=0):
    """The rows of the scan (module docstring)."""
    from deeparc_tpu_torch.kernels.tile import gather_map, sum_rows

    gen = torch.Generator(device=device).manual_seed(seed)
    normal = lambda *shape: torch.randn(shape, generator=gen, dtype=dtype,
                                        device=device)
    ints = lambda hi, n: torch.randint(0, hi, (n,), generator=gen,
                                       device=device)
    vals16 = normal(M, 16)
    table16 = normal(C, 16)
    cam_ids = ints(C, M).to(torch.int32)
    pt_sorted = torch.sort(ints(N, M)).values.to(torch.int32)
    # the cumsum difference: the running sum at each segment's last row
    seg_ends = (torch.searchsorted(pt_sorted, torch.arange(
        1, N + 1, dtype=torch.int32, device=device)) - 1)
    cam_map = gather_map(cam_ids, C, SEGMENT)
    pt_map = gather_map(pt_sorted, N, SEGMENT)
    rows = normal(M // W, W, 16)
    planes = normal(W, M // W)
    esz = vals16.element_size()

    def cumsum_seg():
        cs = torch.cumsum(vals16, dim=0)
        ends = cs[seg_ends.clamp(min=0)] * (seg_ends >= 0)[:, None]
        return torch.diff(ends, dim=0, prepend=torch.zeros_like(ends[:1]))

    add_sorted = lambda: torch.zeros((N, 16), dtype=dtype,
                                     device=device).index_add_(
        0, pt_sorted, vals16)
    add_cams = lambda: torch.zeros((C, 16), dtype=dtype,
                                   device=device).index_add_(0, cam_ids,
                                                             vals16)
    cands = [
        Candidate("gather_(M,16)_from_(C,16)", lambda: table16[cam_ids],
                  nbytes(table16, cam_ids) + M * 16 * esz,
                  check=("take", table16, cam_ids)),
        Candidate("segsum_sorted_index_add_(M,16)->(N,16)", add_sorted,
                  nbytes(vals16, pt_sorted) + N * 16 * esz,
                  check=("add_at", vals16, pt_sorted, N)),
        Candidate("segsum_sorted_cumsum_(M,16)->(N,16)", cumsum_seg,
                  nbytes(vals16, seg_ends) + N * 16 * esz,
                  check=("add_at", vals16, pt_sorted, N)),
        Candidate("segsum_sorted_sum_rows_(M,16)->(N,16)",
                  lambda: sum_rows(vals16, pt_sorted, N, pt_map),
                  nbytes(vals16, *pt_map) + N * 16 * esz,
                  check=("add_at", vals16, pt_sorted, N)),
        Candidate("segsum_unsorted_index_add_(M,16)->(C,16)", add_cams,
                  nbytes(vals16, cam_ids) + C * 16 * esz,
                  check=("add_at", vals16, cam_ids, C)),
        Candidate("segsum_unsorted_sum_rows_(M,16)->(C,16)",
                  lambda: sum_rows(vals16, cam_ids, C, cam_map),
                  nbytes(vals16, *cam_map) + C * 16 * esz,
                  check=("add_at", vals16, cam_ids, C)),
    ]
    cands += onehot_cands(
        "onehot_bin_(M,16)->(C,16)",
        lambda d: onehot_bin(vals16, cam_ids, C, d), vals16, cam_ids, C,
        ("add_at", vals16, cam_ids, C), C, dtype)
    cands += onehot_cands(
        "onehot_lookup_(M,16)", lambda d: onehot_read(table16, cam_ids, d),
        table16, cam_ids, C, ("take", table16, cam_ids), M, dtype)
    rr = M // W * W
    cands += [
        Candidate("rowreduce_(M/W,W,16)->(.,16)", lambda: rows.sum(dim=1),
                  nbytes(rows) + M // W * 16 * esz,
                  check=("add_at", rows.reshape(-1, 16),
                         torch.arange(rr, device=device) // W, M // W)),
        Candidate("planereduce_(W,M/W)->(M/W,)",
                  lambda: torch.sum(planes * planes, dim=0),
                  nbytes(planes) + M // W * esz),
        Candidate("fma8_(M,16)", lambda: fma8(vals16), 2 * nbytes(vals16),
                  2.0 * 8 * M * 16, str(dtype).replace("torch.", "")),
    ]
    return cands


def matmul_candidate(device, n=MATMUL_N, seed=0):
    """The compute anchor: an (n, n) x (n, n) bf16 ``torch.matmul``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((n, n), generator=gen, device=device,
                    dtype=torch.float32).to(torch.bfloat16)
    return Candidate(f"matmul_{n}_bf16", lambda: torch.matmul(a, a),
                     3 * nbytes(a), 2.0 * n ** 3, "bfloat16")


def measure(cands, reps, device) -> dict:
    """{name: ms, bytes, GB/s, share of the memory rate[, TFLOP/s, share of
    the peak]} of each candidate; raises on a share above 1.05."""
    out = {}
    for c in cands:
        ms = time_ms(c.fn, reps, device)
        row = dict(ms=ms, gbytes=c.moved / 1e9, gb_per_s=c.moved / ms / 1e6,
                   hbm_share=c.moved / ms / 1e-3 / HBM_BYTES_PER_S)
        if c.ops:
            row.update(tflops=c.ops / ms / 1e9,
                       peak_share=c.ops / ms / 1e-3 / PEAK_FLOPS[c.ops_dtype])
        if device.type == "cuda":
            check_share(f"{c.name} bytes", row["hbm_share"])
            if c.ops:
                check_share(f"{c.name} operations", row["peak_share"])
        out[c.name] = row
    return out


def run(device="cuda", M=4_000_000, N=400_000, C=2048, W=16,
        dtype="float32", reps: int = 5, matmul_n: int = MATMUL_N) -> dict:
    """The scan as a dict (the JSON line's fields)."""
    from deeparc_tpu_torch.kernels import reset_launch_counts

    dev = check_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    rows = measure(candidates(M, N, C, W, DTYPES[dtype], dev), reps, dev)
    rows.update(measure([matmul_candidate(dev, matmul_n)], reps, dev))
    return dict(card_fields(dev), M=M, N=N, C=C, W=W, dtype=dtype, reps=reps,
                rows=rows, launches={"sum_rows": launch_counts()["sum_rows"]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--m", type=int, default=4_000_000)
    ap.add_argument("--n", type=int, default=400_000)
    ap.add_argument("--c", type=int, default=2048)
    ap.add_argument("--w", type=int, default=16)
    ap.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    ap.add_argument("--matmul-n", type=int, default=MATMUL_N)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.m, args.n, args.c, args.w,
                         args.dtype, args.reps, args.matmul_n)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``deeparc_tpu_torch``) on one card.

    python3 chip_smoke.py                    # the full run, one card
    python3 chip_smoke.py --n-points 20000   # the same phases, smaller rig

Phases (any failure raises and exits non-zero):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
     exits 1 without a CUDA device;
  2. build the hand-written kernels from ``deeparc_tpu_torch/kernels/csrc``;
  3. each kernel against its plain PyTorch version on the card, in float64
     and float32, at the main path's shapes: the 8x24-cell occlusion rig,
     band-prepped, for the banded pair, and a uniform-random rig of the
     same size for the monolithic pair (max relative error against the
     stated tolerance; milliseconds, median of CUDA-event timings);
  4. the main path: ``run_pipeline`` on the 8x24-cell occlusion rig
     (400k points), float64 on the card; the banded kernels must have
     launched and the final RMSE must sit under twice the pixel noise;
  5. a small uniform-random rig through ``run_pipeline``, which takes the
     monolithic kernels;
then one JSON line with every kernel's record, the nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

# max relative error (max |kernel - plain| / max |plain|, per output) that a
# kernel may show against its plain version: float64 sums in another order
# differ in the last digits; float32 sums over ~1e6 terms differ in ~1e-5
TOLERANCE = {"float64": 1e-9, "float32": 2e-3}
PIXEL_NOISE = 1.0
SOURCE = "deeparc_tpu_torch/kernels/csrc/rig_grid.cu"
REPLACES = {
    "linearize_grid_banded": "deeparc_tpu/kernels/rig_pallas.py:615",
    "cost_grid_banded": "deeparc_tpu/kernels/rig_pallas.py:777",
    "linearize_grid": "deeparc_tpu/kernels/rig_pallas.py:363",
    "cost_grid": "deeparc_tpu/kernels/rig_pallas.py:859",
}


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout else "n/a"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def flagship_rig(n_points, occlusion_rings, seed):
    from deeparc_tpu_torch.io import make_hemisphere_rig

    return make_hemisphere_rig(
        n_arc=8, n_ring=24, n_points=n_points, visibility=10 / 48,
        occlusion_rings=occlusion_rings, pixel_noise=PIXEL_NOISE,
        point_noise=0.02, seed=seed).data


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, dtype_name, kernel_out, plain_out):
    """Per-output errors of a kernel against its plain version; raises on a
    non-finite output, a shape mismatch or an error over tolerance."""
    import torch

    kernel_out = kernel_out if isinstance(kernel_out, tuple) else (kernel_out,)
    plain_out = plain_out if isinstance(plain_out, tuple) else (plain_out,)
    labels = (("cost", "g_p", "hpp", "g_slots", "hcc_slots", "E")
              if len(kernel_out) == 6 else ("cost",))
    worst_rel = worst_abs = 0.0
    for label, k, p in zip(labels, kernel_out, plain_out):
        if k.shape != p.shape:
            raise AssertionError(f"{name} {label}: shape {tuple(k.shape)} "
                                 f"!= plain {tuple(p.shape)}")
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{name} {label}: non-finite output")
        diff = float((k.double() - p.double()).abs().max())
        scale = float(p.double().abs().max())
        rel = diff / scale if scale > 0 else diff
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
        print(f"  {name:22s} {dtype_name} {label:9s} max_rel_err={rel:.3e} "
              f"max_abs_err={diff:.3e} (tol {TOLERANCE[dtype_name]:.0e})")
        if rel > TOLERANCE[dtype_name]:
            raise AssertionError(f"{name} {label} {dtype_name}: relative "
                                 f"error {rel:.3e} over tolerance")
    return worst_rel, worst_abs


def kernel_inputs(data, dtype, banded):
    """Arguments for the four wrappers on the main path's shapes: the
    pipeline's full-BA free mask (gauge extrinsic and intrinsics frozen)."""
    import dataclasses

    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.rig_band import band_grid
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene, slot_params

    scene = from_deeparc(data, dtype=dtype, device="cuda")
    grid = grid_from_scene(scene)
    free = freeze_masks(scene)
    params = scene.params
    if banded:
        prep = band_grid(grid)
        if prep is None:
            raise AssertionError("band_grid declined the occlusion rig")
        grid = prep.grid
        params = dataclasses.replace(params,
                                     points=params.points[prep.perm.long()])
        free = dataclasses.replace(free, points=free.points[prep.perm.long()])
    else:
        prep = None
    R, K = grid.onehot_outer.shape[1], grid.onehot_intr.shape[1]
    cam_free = flatten_camera(free)
    rows = cam_free[: 6 * R].reshape(R, 6)
    intr = cam_free[6 * R:].reshape(K, 6)
    tables = (rows[grid.slot_outer.long()], rows[grid.slot_inner.long()],
              intr[grid.slot_intr.long()])
    sp = slot_params(params, grid)
    return params.points, free.points, sp, grid, tables, prep


def phase_kernels(args, records):
    """Phase 3; returns the occlusion rig for the main path."""
    import torch

    from deeparc_tpu_torch.kernels import rig_grid as k

    print("[phase 3] kernels vs plain versions on the card")
    rigs = {True: flagship_rig(args.n_points, 6, 0),
            False: flagship_rig(args.n_points, None, 1)}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for banded, data in rigs.items():
            pts, pf, sp, grid, tables, prep = kernel_inputs(data, dtype,
                                                            banded)
            density = float(grid.mask.mean())
            if banded:
                (bw_lin, bw_cost), (bb_lin, bb_cost) = prep.widths
                print(f"  banded rig: {pts.shape[0]} points, "
                      f"{grid.mask.shape[1]} cells, density {density:.4f}, "
                      f"lin groups {prep.lin_groups}, cost groups "
                      f"{prep.cost_groups}")
                calls = {
                    "linearize_grid_banded": (
                        k.linearize_grid_banded, k.linearize_grid_banded_plain,
                        (pts, pf, sp, grid, *tables, grid.band[0], bw_lin),
                        dict(block_np=bb_lin, intr_frozen=True,
                             pxm=grid.band[2])),
                    "cost_grid_banded": (
                        k.cost_grid_banded, k.cost_grid_banded_plain,
                        (pts, sp, grid, grid.band[1], bw_cost),
                        dict(block_np=bb_cost, pxm=grid.band[3])),
                }
            else:
                print(f"  uniform rig: {pts.shape[0]} points, "
                      f"{grid.mask.shape[1]} cells, density {density:.4f}")
                calls = {
                    "linearize_grid": (k.linearize_grid,
                                       k.linearize_grid_plain,
                                       (pts, pf, sp, grid, *tables),
                                       dict(block_np=256)),
                    "cost_grid": (k.cost_grid, k.cost_grid_plain,
                                  (pts, sp, grid), dict(block_np=1024)),
                }
            for name, (kern, plain, a, kw) in calls.items():
                got, want = kern(*a, **kw), plain(*a, **kw)
                torch.cuda.synchronize()
                rel, ab = compare(name, dname, got, want)
                ms = time_ms(lambda: kern(*a, **kw), args.reps)
                plain_ms = time_ms(lambda: plain(*a, **kw), args.reps)
                print(f"  {name:22s} {dname} kernel {ms:.3f} ms, plain "
                      f"{plain_ms:.3f} ms (median of {args.reps})")
                rec = records.setdefault(name, {})
                rec[dname] = dict(max_rel_err=rel, max_abs_err=ab, ms=ms,
                                  plain_ms=plain_ms)
            del got, want, pts, pf, sp, grid, tables, prep, calls
            torch.cuda.empty_cache()
    return rigs[True]


def run_main_path(data, args, label):
    import torch

    from deeparc_tpu_torch.config import PipelineOptions, SolverOptions
    from deeparc_tpu_torch.pipeline import run_pipeline

    opts = PipelineOptions(
        solver=SolverOptions(max_iterations=args.max_iterations),
        write_snapshots=False)
    torch.cuda.synchronize()
    t0 = time.time()
    res = run_pipeline(data, opts, device="cuda", dtype=torch.float64,
                       verbose=True)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    per_iter = res.solve_seconds / max(res.solve_iterations, 1)
    print(f"  {label}: points {res.scene.n_points}, rounds "
          f"{res.filter_rounds}, final_cost {res.final_cost:.6e}, "
          f"final_rmse_px {res.final_rmse_px:.6f}, LM iterations "
          f"{res.solve_iterations}, {per_iter:.6f} s/iteration, pipeline "
          f"{seconds:.3f} s (max_iterations {args.max_iterations} per solve)")
    if not res.final_rmse_px < 2 * PIXEL_NOISE:
        raise AssertionError(f"{label}: final RMSE {res.final_rmse_px} px "
                             f"not under {2 * PIXEL_NOISE} px")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-points", type=int, default=400_000,
                    help="points of the 8x24-cell rigs (cut only this)")
    ap.add_argument("--max-iterations", type=int, default=100,
                    help="LM iterations per solve")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs per kernel and plain version")
    args = ap.parse_args(argv)

    import torch

    smi = nvidia_smi()
    print(f"[phase 1] nvidia-smi: {smi}")
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels need one", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    print(f"  device: {name}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    from deeparc_tpu_torch.kernels import build, rig_grid as k

    print("[phase 2] build")
    t0 = time.time()
    build.library()
    print(f"  kernels built and loaded in {time.time() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip())

    records: dict = {}
    data = phase_kernels(args, records)

    print("[phase 4] main path: run_pipeline, 8x24-cell occlusion rig, "
          "float64")
    print(f"  rig: {data.n_points} points after the track filter, "
          f"{data.n_obs} observations"
          + ("" if args.n_points == 400_000 else
             f" (n_points cut from 400000 to {args.n_points})"))
    k.reset_launch_counts()
    run_main_path(data, args, "occlusion rig")
    for fn in (k.linearize_grid_banded, k.cost_grid_banded):
        if fn.launches <= 0:
            raise AssertionError(f"{fn.__name__} was not launched")

    print("[phase 5] uniform-random rig through run_pipeline (monolithic)")
    from deeparc_tpu_torch.io import make_hemisphere_rig

    small = make_hemisphere_rig(n_arc=5, n_ring=12, n_points=20_000,
                                visibility=0.3, pixel_noise=PIXEL_NOISE,
                                point_noise=0.02, seed=2).data
    run_main_path(small, args, "uniform rig")
    launches = {fn.__name__: fn.launches for fn in k.KERNEL_WRAPPERS}
    print(f"  launches on the main path: {launches}")
    for kname, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kname} was not launched on the main path")

    kernels = []
    for kname, rec in records.items():
        r64 = rec["float64"]
        kernels.append(dict(
            name=kname, route="cuda", source=SOURCE, replaces=REPLACES[kname],
            launches=launches[kname], max_abs_err=r64["max_abs_err"],
            max_rel_err=r64["max_rel_err"], ms=r64["ms"],
            plain_ms=r64["plain_ms"], float32=rec["float32"]))
    assert "jax" not in sys.modules, "the port imported jax"
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``deeparc_tpu_torch``) on one card.

    python3 chip_smoke.py                    # the full run, one card
    python3 chip_smoke.py --n-points 20000 --tile-points 100000 \
        --dense-points 20000                 # smaller
    python3 chip_smoke.py --cost-only        # the two cost wrappers alone
    python3 chip_smoke.py --new-paths-only   # phases 10-18 alone
    python3 chip_smoke.py --new-paths-only 13   # the sharded engines alone
    python3 chip_smoke.py --new-paths-only 14   # the on-device LM driver
    python3 chip_smoke.py --new-paths-only 15   # the generated scenes
    python3 chip_smoke.py --new-paths-only 16   # the impl paths
    python3 chip_smoke.py --new-paths-only 17   # the measurement scripts
    python3 chip_smoke.py --new-paths-only 18   # the Schur reduction

Phases (any failure raises and exits non-zero):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
     exits 1 without a CUDA device;
  2. build the hand-written kernels from ``deeparc_tpu_torch/kernels/csrc``
     (one nvcc per source, in parallel);
  3. each grid kernel against its plain PyTorch version on the card, in
     float64 and float32, at the grid path's shapes: the 8x24-cell
     occlusion rig, band-prepped, for the banded pair, and a uniform-random
     rig of the same size for the monolithic pair; then ``linearize_grid``
     on a uniform rig with 42 extrinsic plus intrinsic rows, and
     ``linearize_grid_banded`` with the intrinsics free on an occlusion rig
     of the same 8x26 cells, whose float64 E rows no longer fit the
     shared-memory tiles of ``linearize_mono`` / ``linearize_band`` (each
     linearize's route is printed); operations are counted over the live
     slots; the monolithic pair takes the plane stack a solve builds once
     (``mono_stack``), whose build time is printed on its own line, and
     ``cost_grid`` called without it is split into its stack build and
     its kernels; both cost kernels' bounds count the bytes ``cost_band``
     must read (the mask planes, the xy sectors holding a live slot, the
     table rows of the bands), printed beside the whole stacks' bytes;
     ``cost_grid_banded`` is also held against its plain version with the
     Huber and Cauchy losses in float64;
  3b. one classic LM step on the uniform-random rig (the ``linearize_grid``
     path), split into linearize / Schur solve / trial cost, with the
     device's idle share; the step run twice must give the same bits;
  4. one banded LM step on the band-prepped occlusion flagship, split the
     same way, run twice must give the same bits; then the grid main
     path: ``run_pipeline`` on
     the 8x24-cell occlusion rig (400k points), float64; the banded kernels
     and the Schur reduction (``schur_reduce``) must launch and the final
     RMSE must sit under twice the pixel noise;
  5. a small uniform-random rig through ``run_pipeline`` (monolithic; the
     monolithic kernels and ``schur_reduce`` must launch);
  6. each tile kernel against its plain version on the card at the tile
     path's shapes: the windowed BAL scene (2000 shuffled cameras, 1M
     points, 8 observations each, 8 hub cameras), laid out with locality
     for ``tile_linearize_local`` / ``tile_sweep_local`` and without it
     (V = 2000 global cells) for ``tile_sweep``, each sweep with the
     sorted jcam copy the solver builds once per LM step (``tile_sweep``:
     from unrounded working-dtype rows; ``tile_sweep_local``: from the
     stored planes), held bit for bit against its plain version, with its
     build time; float64, float32 and bf16 planes
     (``tile_linearize_local`` split into its row pass and its bin pass by
     device time); each kernel run twice must give the same bits; the
     step's fixed-order row sums
     (``sum_rows``: the chunk bins, F = 18 and 171; the cells into the
     camera vector, F = 1; the block-Jacobi blocks, F = 36; a row piece of
     the torch chunk path, F = 18 and 171) against ``index_add_`` through
     the layouts' own maps, each run twice giving the same bits;
     6b splits one tile LM step on the locality
     layout by kernel pass and checks that two set-ups of its sweeps give
     the same bits, 6c one on the ``locality=False`` layout into linearize
     / sweep set-up / sweeps / the rest, each with the device's idle
     share; in both, the whole step run twice must give the same bits
     (every sum of the step is in a fixed order);
  7. the tile main path: ``run_pipeline`` on that scene, float64,
     ITERATIVE_SCHUR with 30 PCG iterations; the tile kernels must launch
     and the final RMSE must sit under twice the pixel noise;
  8. ``solve_ba_tiles(locality=False)`` on a smaller scene of the same
     generator: ``tile_sweep`` must launch and the cost must go down; then
     a small scene with several bucket widths (every routing of the step)
     solved on the card and on the CPU must end at the same cost;
  9. the measurement probes (``kernels/probes.py``) against their plain
     versions at the scripts' full shapes: ``fma_pass`` over a (256,
     262144) plane in float32 and float64, ``sweep_payload`` over 977
     tiles in float32 in both modes, with one batched ``torch.matmul`` as
     its library time; then their entry points as a user runs them
     (``deeparc_tpu_torch.scripts.vpu_roofline``, which places
     ``linearize_grid`` on the dense 400k-point rig, and
     ``...microbench_sweep_payload``): the FMA ceiling may not pass 1.05 of
     the published peak, the linearize's share of it not 1.0;
  10. the indexed engine on the occlusion flagship (float64, 4.0M
     observations): one LM step with DENSE_SCHUR, then one with
     ITERATIVE_SCHUR (30 PCG), each split into the Jacobian blocks /
     ``build_system`` / ``solve_schur`` / the trial cost with the device's
     idle share, ``sum_rows`` launches and peak memory, run twice bit for
     bit; the step's fixed-order row sums through the solve's maps against
     ``index_add_``; then ``run_pipeline(engine="indexed")`` with
     at most 10 LM iterations a solve, RMSE under twice the pixel noise;
  11. ``run_incremental`` on the flagship (24 cells a batch, 8 batches, on
     the grid engine; the banded kernels must launch) and on a windowed
     BAL scene of 128 cameras with the pose graph (the tile engine; its
     kernels must launch), at most 20 LM iterations a solve: finite batch
     costs, RMSE under twice the pixel noise;
  12. checkpoint/resume of ``solve_ba_grid`` (banded flagship),
     ``solve_tiles_prepared`` (phase 8's scene) and ``solve_ba`` against
     an uninterrupted solve: the same final cost within 1e-12 relative,
     one ``lm_iteration`` log line per iteration;
  13. the sharded engines (``deeparc_tpu_torch.parallel``): (a)
     ``run_pipeline(engine="grid-sharded")`` on the flagship in a one-rank
     NCCL group that the pipeline starts (``linearize_grid``,
     ``cost_grid`` and ``schur_reduce`` must launch, RMSE under twice the
     pixel noise), and its
     freeze-camera solve against ``solve_ba_grid`` on the monolithic route
     (cost within 1e-9 relative, the same iterations); (b)
     ``run_pipeline(engine="tiles-sharded")`` on phase 7's scene, at most
     10 LM iterations a solve (``tile_linearize_local`` and
     ``tile_sweep_local`` must launch, RMSE under twice the pixel noise);
     (c) one sharded grid step at one rank on phase 3b's rig, split as 3b,
     with the collectives' calls, bytes and time by CUDA events: the same
     bits twice, and phase 3b's unsharded step's bits in points, camera
     vector and cost; (d) a two-rank gloo group of spawned processes, both
     on ``cuda:0``: ``solve_ba_grid_sharded`` (flagship, 10 iterations),
     ``solve_ba_tiles_sharded`` (phase 8's scene, ``locality=False``, so
     ``tile_sweep`` launches; 5 iterations) and ``solve_ba_sharded``
     (flagship, 5 iterations) against the same solves at one rank:
     iterations equal, cost rtol 1e-9, points rtol 1e-7; (e)
     ``dryrun_multichip(1)``;
  14. the on-device LM driver (``driver="while_loop"``: one CUDA graph a
     solve, a conditional WHILE node for the block of LM steps and one for
     PCG in its body, set by the condition kernel of
     ``csrc/graph_loop.cu``) against ``driver="python"``:
     ``solve_ba_grid`` on the banded occlusion flagship and on the
     monolithic uniform-random rig (10 iterations, blocks of 5),
     ``solve_tiles_prepared`` on phase 6's locality layout
     (ITERATIVE_SCHUR, 30 PCG; 6 iterations, blocks of 3) and
     ``solve_ba`` on the flagship (DENSE_SCHUR, 3 iterations): the same
     bits, iterations, status and PCG iterations; at least one
     conditional node in the graph (counted through the driver API); the
     case's hand kernels among the graph's kernel nodes (read through the
     driver API); s per LM iteration of both drivers (the graph's over
     its blocks' replays and reads), peak memory, warm-up and capture +
     instantiate time, device busy and idle share of both over the LM
     loop on the device's clock (the indexed Python driver's twice); no
     private pool (a graph's or a loop body's) outlives its case; (e)
     each grid solve again with the fused-trial step (``fuse_trial=
     True``): both drivers' bits, the classic solve's iterations and its
     cost within 1e-9 relative, one classic and one fused step split by
     the profiler into linearize / cost / select / Schur / the rest, the
     select's bytes; (f) ``solve_ba_grid_sharded`` and ``solve_ba_sharded``
     on the flagship and ``solve_ba_tiles_sharded`` on phase 13d's scene
     at one NCCL rank, both drivers, checked as above;
  15. the device-side scene generators at ``bench.py``'s sizes, float64,
     each called twice for the same bits, timed beside the host scenes of
     that size that phases 3 and 6 build, with the layout's device bytes,
     live observations and peak memory, and solved with the Python driver
     (10 LM iterations, up to 20 where the RMSE needs them; the cost must
     fall and the RMSE sit under twice the pixel noise): (a)
     ``make_grid_rig_device`` (8 x 24 cells, 400k points, occlusion
     rings 6), ``band_grid``, ``solve_ba_grid``: the banded kernels must
     launch; (b) ``make_tile_rig_device`` (track 10), (c)
     ``make_bal_tile_device`` (2000 cameras, 1M points, ``window=None``)
     and (d) ``make_bal_heavytail_device`` (2000 cameras, 1M points, mean
     track 8, buckets from W = 4 to at least 128), each through
     ``solve_tiles_prepared`` (ITERATIVE_SCHUR, 30 PCG): (b) and (d)
     launch ``tile_linearize_local`` and ``tile_sweep_local``, (c)
     ``tile_sweep``, and (d)'s wide buckets run the torch paths (their
     calls counted); (e) 15a's banded solve with ``nan_debugging`` on and
     off (the same bits, s/iteration of each, no check while off), a
     point on camera (0, 0)'s z = 0 plane in a small generated rig (on:
     ``FloatingPointError`` naming an operator or kernel; off: a NaN
     cost, silently), and ``trace_to`` around two iterations of the
     monolithic grid solve, whose Chrome trace must name
     ``linearize_grid``'s kernel;
  16. the impl paths without hand kernels of their own, float64: (a) one
     30-PCG tile step on phase 6's windowed BAL layout under ``pallas``
     (the kernel path) and ``xla`` (the torch chunk linearize and
     sweeps), each split into the linearize, the kernel path's sweep
     set-up, the rhs sweep, one matvec sweep, edot and the trial cost
     (CUDA events), with its wall time, idle share and peak memory; the
     two next states within 1e-9 relative of each other, the same accept
     decision, the xla step run twice bit for bit; (b) the torch paths
     under both drivers, the same bits: ``solve_tiles_prepared(impl=
     "xla")`` on that layout (2 iterations; its graph holds the
     ``gather_cells`` sums) and ``solve_ba_grid(impl="planes")`` on the
     occlusion flagship (3 iterations); (c) ``solve_ba_grid`` on the
     flagship (3 iterations) with ``impl="planes"`` (the fused step by
     default), ``"einsum"`` (the same torch path: the same bits) and
     ``band="none"`` (the monolithic kernels, their launches counted)
     against the kernel path's banded solve: s/iteration, peak memory,
     the same iterations, costs within 1e-9 relative; (d) the CLI with
     ``--impl planes`` on a synthetic rig and ``--impl xla`` on a
     ``.bal`` file: exit 0 and the outputs written;
  17. the measurement entry points of ``deeparc_tpu_torch.scripts``, each
     run as a user runs it (``python -m ...``, a process of its own) on the
     card: ``profile_grid`` on the uniform 400k rig and, with
     ``--occlusion-rings 6``, on the band-prepped flagship (the Schur solve
     in the step's pieces, whose sum with the trial's ``slot_params``
     must lie within 25% of the step's Schur part), ``profile_grid_band``
     (``block_np`` 256 and 512 against the monolithic pair),
     ``profile_planes``, ``profile_tiles`` on the 1M
     BAL scene under ``pallas`` with and without the camera window and
     under ``xla``, ``microbench_ops``, ``microbench_tile_ops`` and the CPU
     anchor ``ceres_equiv_cpu`` (40k points, one rep, 1 and 2 processes);
     every time finite and above 0, every share of a rate or a peak at
     most 1.05, and the hand kernels 1-7 launched, by the counts each
     process read (``profile_grid`` also ``schur_reduce``);
  18. the grid step's Schur reduction (``schur_reduce``,
     ``csrc/rig_schur.cu``) against its plain version at the main path's
     two shapes, the banded flagship's ext-only E (400k x 3 x 192) and
     the uniform rig's (400k x 3 x 240), float64 and float32: largest
     relative gap at most 1e-12 in float64, two runs the same bits, no
     (3N, Cn) temporary, ms beside its bound and beside the plain
     version's three pieces (reduced gradient, be = B^-1 E, correction),
     and the host time of one call beside the plain version's; then random
     ragged shapes (Cn 6, 66, 246; N 1001, 37) the same way;
then one JSON line with the probes' entry points' results, one with
phases 10-18's records, one with the ten kernels' records (errors,
milliseconds, the bound, launches on the main paths, on phase 13's
sharded paths and per LM step at the kernel's timing scene; the probes'
launches are their entry points'), the nvidia-smi line, and the result
line ``{"ok": true, "device": {...}}``.

Every idle share printed is 1 - device busy / window with both on the
device's clock (busy the union of the device's activities clipped to the
window: a step's window lies between two marker kernels launched around
it, an LM loop's is mapped onto the device's clock through its runtime
calls' correlation ids); a share outside [0, 1] raises.

Times are medians of CUDA-event timings. A kernel's bound is the larger of
its bytes (each input read once, each output written once) over 3.35 TB/s
and its operations over the data-sheet peak for its type (float64 34
TFLOP/s, float32 67 TFLOP/s, outside the tensor cores).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

from deeparc_tpu_torch.scripts import (
    OPS_PER_SLOT,
    band_rows,
    bound,
    busy_in,
    cost_band_bytes,
    idle_share,
    loop_window,
    nbytes,
    nvidia_smi,
    time_ms,
)
from deeparc_tpu_torch.scripts.profile_grid import grid_free

# max relative error (max |kernel - plain| / max |plain|, per output) that a
# kernel may show against its plain version: float64 sums in another order
# differ in the last digits; float32 sums over ~1e6 terms differ in ~1e-5;
# bf16 planes differ by one rounding step where the two working values
# straddle a bf16 rounding boundary, and the sweeps sum such planes
TOLERANCE = {"float64": 1e-9, "float32": 2e-3, "bf16": 1e-2,
             # the Schur reduction in float64: one product summed over the
             # points in another order (phase 18)
             "schur": 1e-12}
PIXEL_NOISE = 1.0
GRID_SOURCE = "deeparc_tpu_torch/kernels/csrc/rig_grid.cu"
TILE_SOURCE = "deeparc_tpu_torch/kernels/csrc/tile.cu"
# the main path's route of linearize_grid_banded (rigs whose E tile does not
# fit take linearize_kernel in GRID_SOURCE)
BAND_SOURCE = "deeparc_tpu_torch/kernels/csrc/rig_band.cu"
PROBES_SOURCE = "deeparc_tpu_torch/kernels/csrc/probes.cu"
SCHUR_SOURCE = "deeparc_tpu_torch/kernels/csrc/rig_schur.cu"
REPLACES = {
    "linearize_grid_banded": "deeparc_tpu/kernels/rig_pallas.py:615",
    "cost_grid_banded": "deeparc_tpu/kernels/rig_pallas.py:777",
    "linearize_grid": "deeparc_tpu/kernels/rig_pallas.py:363",
    "cost_grid": "deeparc_tpu/kernels/rig_pallas.py:859",
    "tile_linearize_local": "deeparc_tpu/kernels/tile_pallas.py:573",
    "tile_sweep_local": "deeparc_tpu/kernels/tile_pallas.py:207",
    "tile_sweep": "deeparc_tpu/kernels/tile_pallas.py:282",
    "fma_pass": "scripts/vpu_roofline.py:46",
    "sweep_payload": "scripts/microbench_sweep_payload.py:47",
}
TILE_SCENE = dict(n_cameras=2000, track_length=8, window=128, n_hubs=8,
                  hub_frac=0.15, pixel_noise=PIXEL_NOISE, point_noise=0.02)


def flagship_rig(n_points, occlusion_rings, seed):
    from deeparc_tpu_torch.io import make_hemisphere_rig

    return make_hemisphere_rig(
        n_arc=8, n_ring=24, n_points=n_points, visibility=10 / 48,
        occlusion_rings=occlusion_rings, pixel_noise=PIXEL_NOISE,
        point_noise=0.02, seed=seed).data


def compare(name, dtype_name, kernel_out, plain_out, labels, tol_name=None):
    """Per-output errors of a kernel against its plain version; raises on a
    non-finite output, a shape mismatch or an error over tolerance."""
    import torch

    tol = TOLERANCE[tol_name or dtype_name]
    kernel_out = kernel_out if isinstance(kernel_out, tuple) else (kernel_out,)
    plain_out = plain_out if isinstance(plain_out, tuple) else (plain_out,)
    worst_rel = worst_abs = 0.0
    for label, k, p in zip(labels, kernel_out, plain_out):
        if k.shape != p.shape or k.dtype != p.dtype:
            raise AssertionError(f"{name} {label}: {tuple(k.shape)} {k.dtype}"
                                 f" != plain {tuple(p.shape)} {p.dtype}")
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{name} {label}: non-finite output")
        diff = float((k.double() - p.double()).abs().max())
        scale = float(p.double().abs().max())
        rel = diff / scale if scale > 0 else diff
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, diff)
        print(f"  {name:22s} {tol_name or dtype_name:8s} {label:9s} "
              f"max_rel_err={rel:.3e} max_abs_err={diff:.3e} (tol {tol:.0e})")
        if rel > tol:
            raise AssertionError(f"{name} {label} {dtype_name}: relative "
                                 f"error {rel:.3e} over tolerance")
    return worst_rel, worst_abs


def check_repeatable(name, fn):
    """Two runs of a kernel give the same bits."""
    import torch

    a, b = fn(), fn()
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two runs gave different bits")


def measure(records, name, dtype_name, kern, plain, labels, reps,
            bytes_moved, ops, tol_name=None, mode=None):
    """Compare, check repeatability, time kernel and plain version; the
    record goes under ``records[name]["<dtype or bf16>[:<mode>]"]``."""
    import torch

    got, want = kern(), plain()
    torch.cuda.synchronize()
    rel, ab = compare(name, dtype_name, got, want, labels, tol_name)
    del got, want
    check_repeatable(name, kern)
    ms = time_ms(kern, reps)
    plain_ms = time_ms(plain, reps)
    b_ms, b_by = bound(bytes_moved, ops, dtype_name)
    key = (tol_name or dtype_name) + (f":{mode}" if mode else "")
    print(f"  {name:22s} {key:15s} kernel {ms:.3f} ms, plain {plain_ms:.3f} "
          f"ms, bound {b_ms:.3f} ms ({b_by}), bitwise repeatable")
    records.setdefault(name, {})[key] = dict(
        max_rel_err=rel, max_abs_err=ab, ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------------------
# Grid engine (phases 3-5)
# ---------------------------------------------------------------------------


def kernel_inputs(data, dtype, banded, timings=None):
    """Arguments for the four grid wrappers on the main path's shapes: the
    pipeline's full-BA free mask (gauge extrinsic and intrinsics frozen).
    With ``timings`` (a dict), ``timings["grid_s"]`` gets the seconds of
    the upload and the densify (``from_deeparc`` + ``grid_from_scene``)."""
    import dataclasses

    import torch

    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.rig_band import band_grid
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene, slot_params

    t0 = time.time()
    scene = from_deeparc(data, dtype=dtype, device="cuda")
    grid = grid_from_scene(scene)
    torch.cuda.synchronize()
    if timings is not None:
        timings["grid_s"] = time.time() - t0
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


def band_route(grid, dtype, intr_frozen):
    """The route linearize_grid_banded takes on this rig and dtype: its
    shared-memory E kernel (``linearize_band``) when a 32-point tile's E
    fits, else ``linearize_kernel``."""
    from deeparc_tpu_torch.kernels import rig_grid as k

    R, K = grid.onehot_outer.shape[1], grid.onehot_intr.shape[1]
    blocks = k.linearize_band_route(dtype, "trivial", intr_frozen, R, K,
                                    grid.mask.shape[0])
    return (f"linearize_band ({blocks} blocks)" if blocks else
            "linearize_kernel (the E tile does not fit)"), R + K


def mono_route(grid, dtype):
    """The route linearize_grid takes on this rig and dtype: its own kernel
    (``linearize_mono``) when a 32-point tile's E fits in shared memory,
    else the kernel it shares with the banded wrapper."""
    import torch

    from deeparc_tpu_torch.kernels.build import library

    R, K = grid.onehot_outer.shape[1], grid.onehot_intr.shape[1]
    blocks = library().rig_linearize_mono_grid(
        int(dtype == torch.float64), 0, 6 * (R + K),
        (grid.mask.shape[0] + 31) // 32)
    if blocks < 0:
        raise RuntimeError(f"rig_linearize_mono_grid: cudaError {-blocks}")
    return (f"linearize_mono ({blocks} blocks)" if blocks else
            "linearize_kernel (the E tile does not fit)"), R + K


def phase_grid_kernels(args, records):
    """Phase 3; returns the rigs {occluded: data}: the occlusion rig of the
    main path (True) and the uniform-random one (False), and the seconds
    the occlusion rig took to build on the host and densify into its
    float64 grid (phase 15a's host counterpart). Two rigs of 8x26
    cells, 42 extrinsic plus intrinsic rows (one past what the float64 E
    tiles hold), check the other routes: a uniform one for linearize_grid,
    an occlusion one, band-prepped, for linearize_grid_banded with the
    intrinsics free (18 camera columns)."""
    import torch

    from deeparc_tpu_torch.io import make_hemisphere_rig
    from deeparc_tpu_torch.kernels import rig_grid as k
    from deeparc_tpu_torch.solver.rig_grid import mono_stack

    print("[phase 3] grid kernels vs plain versions on the card")
    t0 = time.time()
    rigs = {True: flagship_rig(args.n_points, 6, 0)}
    flagship_s = time.time() - t0
    timings: dict = {}
    rigs[False] = flagship_rig(args.n_points, None, 1)
    wide = {occ: make_hemisphere_rig(
        n_arc=8, n_ring=26, n_points=args.n_points, visibility=10 / 48,
        occlusion_rings=occ, pixel_noise=PIXEL_NOISE, point_noise=0.02,
        seed=4).data for occ in (None, 6)}
    cases = ((True, rigs[True], None), (False, rigs[False], None),
             (False, wide[None], "wide"), (True, wide[6], "wide"))
    lin_labels = ("cost", "g_p", "hpp", "g_slots", "hcc_slots", "E")
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for banded, data, tag in cases:
            flagship = banded and tag is None and dtype == torch.float64
            pts, pf, sp, grid, tables, prep = kernel_inputs(
                data, dtype, banded, timings if flagship else None)
            if banded and tag:
                # free intrinsics, so that their Jacobian columns are live
                tables = (*tables[:2], torch.ones_like(tables[2]))
            N, T = grid.mask.shape
            esz = pts.element_size()
            density = float(grid.mask.mean())
            # operations are counted over the live slots the data needs;
            # the bytes are the dense planes each kernel is given
            live = int(grid.mask.sum())
            if banded:
                (bw_lin, bw_cost), (bb_lin, bb_cost) = prep.widths
                # the main path freezes the intrinsics (12 camera columns);
                # the 8x26 rig frees them (18)
                frozen = tag is None
                route, rows = band_route(grid, dtype, frozen)
                print(f"  banded rig{' (' + tag + ')' if tag else ''}: {N} "
                      f"points, {T} cells, {rows} extrinsic plus intrinsic "
                      f"rows, density {density:.4f} ({live} live slots), "
                      f"lin groups {prep.lin_groups}, cost groups "
                      f"{prep.cost_groups}; linearize_grid_banded "
                      f"(intrinsics {'frozen' if frozen else 'free'}) route: "
                      f"{route}")
                lin_in = (nbytes(pts, pf, *grid.band[2]) + T * 78 * esz)
                cost_in = cost_band_bytes(pts, grid.band[3], band_rows(
                    grid.band[1], prep.cost_groups))
                stacks = nbytes(*grid.band[3])
                calls = {
                    "linearize_grid_banded": (
                        k.linearize_grid_banded, k.linearize_grid_banded_plain,
                        (pts, pf, sp, grid, *tables, grid.band[0], bw_lin),
                        dict(block_np=bb_lin, intr_frozen=frozen,
                             pxm=grid.band[2]), lin_in, live),
                    "cost_grid_banded": (
                        k.cost_grid_banded, k.cost_grid_banded_plain,
                        (pts, sp, grid, grid.band[1], bw_cost),
                        dict(block_np=bb_cost, pxm=grid.band[3]), cost_in,
                        live),
                }
            else:
                route, rows = mono_route(grid, dtype)
                print(f"  uniform rig{' (' + tag + ')' if tag else ''}: {N} "
                      f"points, {T} cells, {rows} extrinsic plus intrinsic "
                      f"rows, density {density:.4f} ({live} live slots); "
                      f"linearize_grid route: {route}")
                planes = nbytes(grid.xy0, grid.xy1, grid.mask)
                # the stack a monolithic solve builds once and hands to both
                # kernels
                pxm = mono_stack(grid, (256, 1024))
                if not tag:
                    records.setdefault("cost_grid", {})[
                        dname + ":split"] = cost_split(
                            args, dname, pts, sp, grid, pxm)
                calls = {
                    "linearize_grid": (
                        k.linearize_grid, k.linearize_grid_plain,
                        (pts, pf, sp, grid, *tables),
                        dict(block_np=256, pxm=pxm),
                        nbytes(pts, pf) + planes + T * 78 * esz, live),
                    "cost_grid": (
                        k.cost_grid, k.cost_grid_plain, (pts, sp, grid),
                        dict(block_np=1024, pxm=pxm),
                        cost_band_bytes(pts, (pxm,), T), live),
                }
                stacks = nbytes(pxm)
            if tag:
                calls = {n: c for n, c in calls.items()
                         if n.startswith("linearize")}
            for name, (kern, plain, a, kw, in_bytes, slots) in calls.items():
                out = kern(*a, **kw)
                out_bytes = nbytes(*(out if isinstance(out, tuple) else
                                     (out,)))
                del out
                labels = lin_labels if "linearize" in name else ("cost",)
                measure(records, name, dname,
                        lambda: kern(*a, **kw), lambda: plain(*a, **kw),
                        labels, args.reps, in_bytes + out_bytes,
                        slots * OPS_PER_SLOT[name], mode=tag)
                if name.startswith("linearize"):
                    records[name][dname + (f":{tag}" if tag else "")].update(
                        route=route, rows=rows)
                if name.startswith("cost"):
                    rec = records[name][dname]
                    rec["bound_counts"] = ("the mask planes, the xy planes' "
                                           "32-byte sectors holding a live "
                                           "slot, the points, 30 table "
                                           "columns of the rows read")
                    rec["stack_gbytes"] = stacks / 1e9
                    # the call by device time: the kernel and its fixed-order
                    # sum against the wrapper's own torch ops
                    times = device_ms(lambda: kern(*a, **kw))
                    rec["device_ms"] = dict(
                        kernel=sum(v for n, v in times.items()
                                   if "cost_band" in n),
                        reduce=sum(v for n, v in times.items()
                                   if "reduce_cost" in n))
                    rec["device_ms"]["other"] = (sum(times.values())
                                                 - sum(rec["device_ms"]
                                                       .values()))
                    print(f"  {name} {dname} by device time (ms): "
                          + ", ".join(f"{n} {v:.4f}" for n, v in
                                      rec["device_ms"].items())
                          + f"; by CUDA events {rec['ms']:.4f}")
                    print(f"  {name} {dname}: the bound "
                          f"{rec['bound_ms']:.3f} ms ({rec['bound_by']}) "
                          f"counts {in_bytes / 1e9:.3f} GB read: "
                          f"{rec['bound_counts']} (the whole stack"
                          f"{'s are' if banded else ' is'} "
                          f"{stacks / 1e9:.3f} GB)")
                if name == "cost_grid_banded" and dtype == torch.float64:
                    # the robust losses, each branch of the chain's loss
                    for loss, scale in (("huber", 2.0), ("cauchy", 3.0)):
                        lkw = dict(kw, loss=loss, loss_scale=scale)
                        measure(records, name, dname,
                                lambda: kern(*a, **lkw),
                                lambda: plain(*a, **lkw), labels, args.reps,
                                in_bytes + out_bytes,
                                slots * OPS_PER_SLOT[name], mode=loss)
            del pts, pf, sp, grid, tables, prep, calls
            pxm = None
            torch.cuda.empty_cache()
    del wide
    return rigs, flagship_s + timings["grid_s"]


def cost_wrapper_split(pts, sp, grid):
    """(stack build ms, cost kernels ms) of one ``cost_grid`` call that
    builds its own stack, by profiler device time: everything but the cost
    kernels (the stack, and the small table and point packs) against the
    kernels whose names hold "cost"."""
    from deeparc_tpu_torch.kernels import rig_grid as k

    times = device_ms(lambda: k.cost_grid(pts, sp, grid, block_np=1024))
    kern = sum(v for n, v in times.items() if "cost" in n)
    return sum(times.values()) - kern, kern


def cost_split(args, dname, pts, sp, grid, pxm):
    """cost_grid on the uniform rig, split on the card: the wrapper without
    a stack (:func:`cost_wrapper_split`), and the stack build a solve pays
    once, timed alone with CUDA events."""
    from deeparc_tpu_torch.solver.rig_grid import mono_stack

    build, kern = cost_wrapper_split(pts, sp, grid)
    split = dict(
        wrapper_build_ms=build, wrapper_kernel_ms=kern,
        stack_build_ms=time_ms(lambda: mono_stack(grid, (256, 1024)),
                               args.reps),
        stack_gbytes=nbytes(pxm) / 1e9)
    print(f"  cost_grid {dname:15s} without a stack, by device time: stack "
          f"build {build:.3f} ms, cost kernels {kern:.3f} ms; the solve's "
          f"stack ({split['stack_gbytes']:.3f} GB, built once per solve): "
          f"{split['stack_build_ms']:.3f} ms")
    return split


def host_ms(fn, reps):
    """Median host time of fn from its call to its return, the card's queue
    drained before each call: the host's share of a call that the card
    waits on."""
    import torch

    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(walls)


def phase_cost_only(args):
    """``--cost-only``: the two cost wrappers at the main paths' shapes (the
    band-prepped occlusion flagship for ``cost_grid_banded``, the
    uniform-random rig with its solve's stack for ``cost_grid``, which is
    phase 3b's trial cost), float64 and float32, each by CUDA events, by
    profiler device time (the cost kernel, its sum, the wrapper's torch
    ops) and by host time to return; one JSON line. It reads only the
    wrappers' signatures, so the file run from the root of another tree
    (a parent, a copy with one part of ``cost_band`` changed) times that
    tree in the same call."""
    import torch

    from deeparc_tpu_torch.kernels import rig_grid as k
    from deeparc_tpu_torch.solver.rig_grid import mono_stack

    print("[cost only] the cost wrappers by CUDA events, device and host "
          "time")
    rigs = {True: flagship_rig(args.n_points, 6, 0),
            False: flagship_rig(args.n_points, None, 1)}
    out: dict = {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for banded, data in rigs.items():
            pts, _, sp, grid, _, prep = kernel_inputs(data, dtype, banded)
            if banded:
                (_, w), (_, bn) = prep.widths
                name = "cost_grid_banded"
                call = lambda: k.cost_grid_banded(
                    pts, sp, grid, grid.band[1], w, block_np=bn,
                    pxm=grid.band[3])
            else:
                name, pxm = "cost_grid", mono_stack(grid, (256, 1024))
                call = lambda: k.cost_grid(pts, sp, grid, block_np=1024,
                                           pxm=pxm)
            times = device_ms(call)
            kern = sum(v for n, v in times.items()
                       if "cost" in n and "reduce" not in n)
            red = sum(v for n, v in times.items() if "reduce_cost" in n)
            rec = dict(ms=time_ms(call, args.reps),
                       host_ms=host_ms(call, args.reps), kernel_ms=kern,
                       reduce_ms=red,
                       other_ms=sum(times.values()) - kern - red)
            out.setdefault(name, {})[dname] = rec
            print(f"  {name} {dname}: " + ", ".join(
                f"{n} {v:.4f}" for n, v in rec.items()))
            del pts, sp, grid, prep, call
            pxm = None
            torch.cuda.empty_cache()
    print(json.dumps({"cost_only": out}))


def wall_ms(fn, reps):
    """Median host time of fn between two synchronisations."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        walls.append((time.time() - t0) * 1e3)
    return statistics.median(walls)


def host_us(fn, calls=50):
    """Host time of one call of fn, in microseconds: the median of calls
    issued back to back with no synchronisation between them (the card
    runs behind, so this is what the caller's thread pays)."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(walls)


def device_ms(fn):
    """{kernel name: device ms} of everything one call of fn launches
    (torch.profiler self times); empty when the profiler sees no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            times[e.key] = times.get(e.key, 0.0) + (
                getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0.0)) / 1e3
    return times


# cycles of the marker kernels (torch.cuda._sleep's spin_kernel) that
# bracket a profiled step: about a microsecond
MARKER_CYCLES = 1000


def step_profile(fn):
    """One call of ``fn`` under the profiler, between two marker kernels
    launched right before and right after it (the device idle before the
    first): ({activity name: device ms}, device busy ms, window ms). The
    window runs from the first activity's end to the last one's start on
    the device's clock (the markers, found by their place: the profiler
    may misname a kernel), so it holds the host's launch work and reads
    inside the call; busy is the union of the device's activities in it
    (``scripts.busy_in``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(MARKER_CYCLES)
        fn()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
    acts = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    if len(acts) < 3:
        raise AssertionError("the profile holds no device work of the step")
    lo, hi = acts[0][1], acts[-1][0]
    times: dict = {}
    work = acts[1:-1]
    for a, b, name in work:
        times[name] = times.get(name, 0.0) + (b - a) / 1e3
    return (times, busy_in([(a, b) for a, b, _ in work], lo, hi) / 1e3,
            (hi - lo) / 1e3)


def print_split(label, wall, parts, busy, window):
    """One step's split; the idle share is over the profiled call
    (:func:`step_profile`) and must lie in [0, 1]."""
    rest = wall - sum(parts.values())
    print(f"  {label}: wall {wall:.3f} ms (median of 3); "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
          + f", the rest {rest:.3f} ms; device busy {busy:.3f} of "
          f"{window:.3f} ms of the profiled step, idle share "
          f"{idle_share(busy, window):.4f}")


def grid_step_split(data):
    """Phase 3b: one classic LM step of the monolithic grid path (float64,
    the pipeline's full-BA free mask) on the uniform-random rig of phase 3,
    with the plane stack its solve builds once (timed alone): host wall
    time around the synchronised step; the linearize
    (``assemble_grid_system``) and the trial cost (``grid_cost``) timed
    alone with CUDA events; the Schur solve is the rest; the idle share
    over one profiled step (:func:`step_profile`); the step run twice
    must give the same bits. Returns the kernels' launches in one step."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.rig_grid import (
        assemble_grid_system,
        grid_cost,
        grid_from_scene,
        init_grid_state,
        make_grid_step,
        mono_stack,
        slot_params,
    )

    scene = from_deeparc(data, dtype=torch.float64, device="cuda")
    grid = grid_from_scene(scene)
    free = freeze_masks(scene)
    cam_free = flatten_camera(free)
    params = scene.params
    opts = SolverOptions()
    stack = lambda: mono_stack(grid, (256, 1024))
    pxm = stack()
    step = make_grid_step(opts, params, pxm=pxm)
    state = init_grid_state(params, grid, opts, pxm=pxm)
    run = lambda: step(state, grid, cam_free, free.points)
    sp = slot_params(params, grid)
    print(f"  the solve's plane stack, built once per solve: "
          f"{time_ms(stack, 3):.3f} ms")
    return split_grid_step(
        "one LM step (f64) on the uniform rig", run,
        (k.linearize_grid, k.cost_grid),
        lambda: assemble_grid_system(params.points, sp, grid, cam_free,
                                     free.points, pxm=pxm),
        lambda: grid_cost(params.points, sp, grid, pxm=pxm))


def split_grid_step(label, run, kernels, lin, cost):
    """One grid LM step ``run`` split on the card: host wall time around
    the synchronised step; the linearize ``lin`` and the trial cost
    ``cost`` timed alone with CUDA events; the Schur solve is the rest;
    the idle share over one profiled step (:func:`step_profile`). The
    step run twice from one state must give the same bits. Returns the
    ``kernels``' launches in one step."""
    import torch

    from deeparc_tpu_torch.kernels import reset_launch_counts

    reset_launch_counts()
    run()
    torch.cuda.synchronize()
    per_step = {fn.__name__: fn.launches for fn in kernels}
    wall = wall_ms(run, 3)
    parts = {"linearize": time_ms(lin, 3), "trial cost": time_ms(cost, 3)}
    print_split(f"{label}, Schur solve = the rest", wall, parts,
                *step_profile(run)[1:])
    print(f"  launches in one step: {per_step}")
    check_step_repeats(run, label)
    print("  the step run twice: the same bits")
    return per_step


def banded_step_split(data):
    """Phase 4: one classic LM step of the banded grid path (float64, the
    pipeline's full-BA free mask, intrinsics frozen) on the band-prepped
    occlusion flagship, split as phase 3b splits the monolithic one: host
    wall time around the synchronised step; the linearize
    (``assemble_grid_system`` with the band) and the trial cost
    (``grid_cost`` with the band) timed alone with CUDA events; the Schur
    solve is the rest; the idle share over one profiled step
    (:func:`split_grid_step`); the banded kernels' launches in one
    step. The step run twice from one state must give the same bits."""
    import dataclasses

    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.rig_band import band_grid
    from deeparc_tpu_torch.solver.rig_grid import (
        assemble_grid_system,
        grid_cost,
        grid_from_scene,
        init_grid_state,
        make_grid_step,
        slot_params,
    )

    scene = from_deeparc(data, dtype=torch.float64, device="cuda")
    prep = band_grid(grid_from_scene(scene))
    if prep is None:
        raise AssertionError("band_grid declined the occlusion rig")
    grid, perm = prep.grid, prep.perm.long()
    free = freeze_masks(scene)
    params = dataclasses.replace(scene.params,
                                 points=scene.params.points[perm])
    pf = free.points[perm]
    cam_free = flatten_camera(free)
    R = params.ext_rot.shape[0]
    frozen = not bool(torch.any(cam_free[6 * R:] != 0))
    bws, bbs = prep.widths
    opts = SolverOptions()
    step = make_grid_step(opts, params, band_widths=bws, band_blocks=bbs,
                          band_intr_frozen=frozen)
    state = init_grid_state(params, grid, opts, band_widths=bws,
                            band_blocks=bbs)
    run = lambda: step(state, grid, cam_free, pf)
    sp = slot_params(params, grid)
    split_grid_step(
        f"one banded LM step (f64, intrinsics "
        f"{'frozen' if frozen else 'free'}) on the occlusion flagship", run,
        (k.linearize_grid_banded, k.cost_grid_banded),
        lambda: assemble_grid_system(
            params.points, sp, grid, cam_free, pf, band_width=bws[0],
            band_block=bbs[0], band_intr_frozen=frozen),
        lambda: grid_cost(params.points, sp, grid, band_width=bws[1],
                          band_block=bbs[1]))


def run_main_path(data, args, label, solver=None, engine="auto"):
    import torch

    from deeparc_tpu_torch.config import PipelineOptions, SolverOptions

    from deeparc_tpu_torch.pipeline import run_pipeline

    solver = solver or SolverOptions(max_iterations=args.max_iterations)
    opts = PipelineOptions(solver=solver, write_snapshots=False,
                           engine=engine)
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
          f"{res.solve_iterations}, CG iterations {res.cg_iterations}, "
          f"{per_iter:.6f} s/iteration, pipeline {seconds:.3f} s (LM bound "
          f"{solver.max_iterations} iterations per solve)")
    if not res.final_rmse_px < 2 * PIXEL_NOISE:
        raise AssertionError(f"{label}: final RMSE {res.final_rmse_px} px "
                             f"not under {2 * PIXEL_NOISE} px")
    return res


# ---------------------------------------------------------------------------
# Tile engine (phases 6-8)
# ---------------------------------------------------------------------------


def tile_layout(data, locality):
    import torch

    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.rig_grid import slot_params
    from deeparc_tpu_torch.solver.tiles import pack_cells, tiles_from_scene

    scene = from_deeparc(data, dtype=torch.float64, device="cuda")
    free = freeze_masks(scene)
    t0 = time.time()
    tiles, params_t, free_t = tiles_from_scene(scene, free, locality=locality)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    cam_free = flatten_camera(free)
    packed = pack_cells(slot_params(params_t, tiles.cells), tiles.cells,
                        cam_free)
    layout_bytes = sum(nbytes(b.cell, b.xy0, b.xy1, b.mask, *b.loc)
                       for b in tiles.buckets)
    print(f"  layout (locality={locality}): {tiles.cells.cols.shape[0]} "
          f"cells, widths {[b.cell.shape[1] for b in tiles.buckets]}, rows "
          f"{[b.cell.shape[0] for b in tiles.buckets]}, v_local "
          f"{[b.loc[1].shape[1] if b.loc else None for b in tiles.buckets]}, "
          f"chunks {[b.loc[1].shape[0] if b.loc else None for b in tiles.buckets]}, "
          f"{layout_bytes / 1e9:.3f} GB of planes, built in {build_s:.1f} s")
    return tiles, params_t, free_t, packed, cam_free


def tile_step_breakdown(layout):
    """One classic tile LM step (30 PCG iterations) on the main path's
    layout, float64: host wall time around a synchronised step, then the
    device time of each kernel under torch.profiler, split into the
    linearize's row and bin passes (one block per run of bins), the PCG
    sweeps' row passes (rhs / matvec; edot) and bin passes (one block per
    chunk), their chunk-sorted plane copy, the fixed-order sums
    (``gather_cells``: the chunk bins of the sweeps and of the linearize
    into the cells, the cells into the camera vector and the block-Jacobi
    blocks), and everything else (torch ops). Then two set-ups of the
    step's sweeps (each with its own sorted copy) must give the same bits
    in rhs, matvec and edot, and the whole step run twice the same bits.
    Returns the launches in one step."""
    import torch

    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.solver.linalg import inv3x3
    from deeparc_tpu_torch.solver.tiles import (
        _make_kernel_sweeps,
        init_tile_state,
        linearize_tiles_mixed,
        make_tile_step,
    )

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.kernels import tile as kt

    tiles, params_t, free_t, packed, cam_free = layout
    opts = SolverOptions(linear_solver="iterative_schur", cg_max_iterations=30)
    step = make_tile_step(opts, params_t)
    state = init_tile_state(params_t, tiles, opts, cam_free)
    k.reset_launch_counts()
    state, info = step(state, tiles, cam_free, free_t)
    torch.cuda.synchronize()
    per_step = {fn.__name__: fn.launches
                for fn in (k.tile_linearize_local, k.tile_sweep_local,
                           kt.sort_jcam_planes, kt.sum_rows)}
    run = lambda: step(state, tiles, cam_free, free_t)
    _, info = run()
    wall = wall_ms(run, 3)
    parts = ("linearize_rows", "linearize_bins", "gsweep_rows",
             "lsweep_bins", "edot_rows", "sort_planes", "gather_cells")
    split = dict.fromkeys(parts + ("other",), 0.0)
    times, busy, window = step_profile(run)
    for key, ms in times.items():
        split[next((p for p in parts if p in key), "other")] += ms
    print(f"  one LM step (f64, {info.cg_iters} PCG iterations): wall "
          f"{wall:.3f} ms (median of 3); device time by part (ms): "
          + ", ".join(f"{p} {v:.3f}" for p, v in split.items())
          + f"; device busy {busy:.3f} of {window:.3f} ms of the profiled "
          f"step, idle share {idle_share(busy, window):.4f}")

    sys_, lin_planes = linearize_tiles_mixed(params_t.points, packed, tiles,
                                             free_t, cam_free.numel())
    binv = inv3x3(sys_.hpp + torch.eye(3, dtype=sys_.hpp.dtype,
                                       device="cuda"))
    v = torch.randn((tiles.cells.cols.shape[0], 18), dtype=torch.float64,
                    device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    outs = []
    for _ in range(2):
        sweep, edot = _make_kernel_sweeps(tiles, sys_, binv, lin_planes, None,
                                          256)
        outs.append((sweep(None, True), sweep(v, False), edot(v)))
    if not all(torch.equal(x, y) for x, y in zip(*outs)):
        raise AssertionError("two set-ups of one tile LM step's sweeps gave "
                             "different bits")
    check_step_repeats(run, "tile step on the locality layout")
    print("  the step's sweeps (rhs, matvec, edot), set up twice: the same "
          "bits; the whole step run twice: the same bits")
    return per_step


def check_step_repeats(run, label):
    """One LM step (grid or tile) run twice from one state gives the same
    bits in the next state's points, camera vector and cost: every sum of
    the step on the card is in a fixed order."""
    import torch

    a, b = run()[0], run()[0]
    for field in ("points", "cam_vec", "cost"):
        if not torch.equal(getattr(a, field), getattr(b, field)):
            raise AssertionError(f"one LM step, the {label}, run twice: "
                                 f"different bits in {field}")


def tile_global_step_split(layout):
    """Phase 6c: one tile LM step (30 PCG iterations, float64) on the
    ``locality=False`` layout of phase 6, whose sweeps are ``tile_sweep``:
    host wall time around the synchronised step; the linearize
    (``linearize_tiles_mixed``), the sweep set-up (``_make_kernel_sweeps``:
    the transposed planes and each bucket's cell-sorted jcam copy) and the
    step's sweeps (rhs, one matvec per PCG iteration, edot) timed alone
    with CUDA events; the idle share over one profiled step
    (:func:`step_profile`); the whole step run twice must give the same
    bits (its linearize is the torch chunk path, summing each row piece
    into the cells in fixed order). Returns tile_sweep's launches in one
    step."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.solver.linalg import inv3x3
    from deeparc_tpu_torch.solver.tiles import (
        _make_kernel_sweeps,
        init_tile_state,
        linearize_tiles_mixed,
        make_tile_step,
    )

    tiles, params_t, free_t, packed, cam_free = layout
    opts = SolverOptions(linear_solver="iterative_schur", cg_max_iterations=30)
    step = make_tile_step(opts, params_t)
    state = init_tile_state(params_t, tiles, opts, cam_free)
    run = lambda: step(state, tiles, cam_free, free_t)
    k.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    _, info = run()
    torch.cuda.synchronize()
    per_step = {"tile_sweep": k.tile_sweep.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = wall_ms(run, 3)
    lin = lambda: linearize_tiles_mixed(state.points, packed, tiles, free_t,
                                        cam_free.numel())
    sys, lin_planes = lin()
    binv = inv3x3(sys.hpp + torch.eye(3, dtype=sys.hpp.dtype, device="cuda"))
    setup = lambda: _make_kernel_sweeps(tiles, sys, binv, lin_planes, None,
                                        256)
    sweep, edot = setup()
    v = torch.randn((tiles.cells.cols.shape[0], 18), dtype=torch.float64,
                    device="cuda")

    def sweeps():
        sweep(None, True)
        for _ in range(info.cg_iters):
            sweep(v, False)
        edot(v)

    parts = {"linearize": time_ms(lin, 3), "sweep set-up": time_ms(setup, 3),
             f"sweeps (2 + {info.cg_iters})": time_ms(sweeps, 3)}
    print_split(f"one LM step (f64, {info.cg_iters} PCG iterations, peak "
                f"{peak:.3f} GiB)", wall, parts, *step_profile(run)[1:])
    check_step_repeats(run, "tile step on the locality=False layout")
    print("  the whole step run twice: the same bits")
    return per_step


def lin_args(b, points, free, packed, dtype, local):
    """tile_linearize_local's inputs for bucket b. ``local=False`` lays a
    global-id bucket out as ONE chunk whose local table is the whole
    packed table (the planes that tile_sweep then sweeps)."""
    import torch

    Nb = b.cell.shape[0]
    pts = torch.cat([points.T, free.T, torch.zeros((2, Nb), dtype=dtype,
                                                   device=points.device)])
    if local:
        cell_t, tables = b.loc[0].T, packed[b.loc[1].long()]
    else:
        cell_t, tables = b.cell.T, packed[None]
    c = lambda t: t.to(dtype).contiguous()
    return (c(pts), cell_t.contiguous(), c(b.xy0.T), c(b.xy1.T), c(b.mask.T),
            c(tables))


def check_sum(sums, label, dname, tol_name, kern, part, dst, n_out, reps):
    """A fixed-order row sum (``sum_rows``) against its plain version,
    ``index_add_`` over ``dst``: within tolerance, bitwise repeatable, and
    both timed; the record goes under ``sums[label]``."""
    import torch

    from deeparc_tpu_torch.kernels import tile as k

    plain = lambda: k.sum_rows_plain(part, dst, n_out)
    got = kern()
    rel, ab = compare("sum_rows", dname, got, plain(), (label.split(":")[1],),
                      tol_name)
    check_repeatable(f"sum_rows {label}", kern)
    ms, plain_ms = time_ms(kern, reps), time_ms(plain, reps)
    F = part[0].numel()
    sums[label] = dict(rows=n_out, F=F, sources=part.shape[0], ms=ms,
                       index_add_ms=plain_ms, max_rel_err=rel,
                       max_abs_err=ab)
    print(f"  sum_rows {label:34s} {part.shape[0]} rows of {F} into "
          f"{n_out}: {ms:.3f} ms (index_add_ {plain_ms:.3f} ms), bitwise "
          f"repeatable")
    del got
    torch.cuda.synchronize()


def step_sums(layouts, key, dtype, sums, reps):
    """The tile step's other fixed-order sums against ``index_add_`` on the
    card, through the layouts' own maps, on values made from a seed: the
    cells into the camera vector (``cells_to_flat``, F = 1) and the
    block-Jacobi blocks (F = 36) on the locality layout, and the first row
    piece of the torch chunk path (F = 18, 171) of the locality=False
    layout's widest bucket, its masked slots zero as the step's are (its
    map cuts a hub cell's slots into segments: two passes)."""
    import torch

    from deeparc_tpu_torch.kernels import tile as k
    from deeparc_tpu_torch.solver.tiles import (
        _PIECE_SEGMENT,
        _block_rows,
        _row_pieces,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    rand = lambda *shape: torch.randn(shape, dtype=dtype, device="cuda",
                                      generator=gen)
    tiles, cam_free = layouts[True][0], layouts[True][4]
    cells, C = tiles.cells, cam_free.numel()
    V = cells.cols.shape[0]
    dst = cells.cols.reshape(-1)
    part = rand(V * 18)
    check_sum(sums, f"{key}:cells -> camera vector", key, None,
              lambda: k.sum_rows(part, dst, C, cells.maps[0]), part, dst, C,
              reps)
    dst = _block_rows(cells.cols)
    part = rand(3 * V, 6, 6)
    check_sum(sums, f"{key}:block-Jacobi blocks", key, None,
              lambda: k.sum_rows(part, dst, C // 6, cells.maps[1]), part,
              dst, C // 6, reps)
    tiles = layouts[False][0]
    b = max(tiles.buckets, key=lambda bb: bb.cell.numel())
    V = tiles.cells.cols.shape[0]
    r0, r1 = next(_row_pieces(*b.cell.shape))
    dst = b.cell[r0:r1].reshape(-1)
    live = (b.mask[r0:r1].reshape(-1, 1) > 0.5).to(dtype)
    pmap = b.pieces[0]
    print(f"  the piece's map: {pmap[1].numel()} live slots, "
          + (f"{pmap[3].numel()} segments of at most {_PIECE_SEGMENT}"
             if len(pmap) == 4 else "one pass"))
    for F in (18, 171):
        part = rand(dst.numel(), F) * live
        check_sum(sums, f"{key}:chunk path piece F={F}", key, None,
                  lambda: k.sum_rows(part, dst, V, pmap), part, dst, V, reps)
    del part


def phase_tile_kernels(args, records):
    """Phase 6; returns the scene for the main path, the per-step launches,
    the row sums' records, the locality layout, and the seconds of the
    scene's host build, upload and layout (phase 15c/d's host
    counterpart)."""
    import torch

    from deeparc_tpu_torch.io import make_bal_windowed_host
    from deeparc_tpu_torch.kernels import tile as k
    from deeparc_tpu_torch.solver.linalg import inv3x3

    print("[phase 6] tile kernels vs plain versions on the card")
    t0 = time.time()
    data = make_bal_windowed_host(n_points=args.tile_points, seed=0,
                                  **TILE_SCENE)
    scene_s = time.time() - t0
    print(f"  windowed BAL scene: {data.n_points} points, {data.n_obs} "
          f"observations, {data.n_extrinsics} cameras "
          f"({scene_s:.1f} s)")
    t0 = time.time()
    layouts = {True: tile_layout(data, True)}
    bal_s = scene_s + time.time() - t0
    layouts[False] = tile_layout(data, False)
    sums: dict = {}
    lin_labels = ("cost", "pout", "r_t", "jx_t", "jcam_t", "gc", "hc")
    rng = torch.Generator(device="cuda").manual_seed(0)
    cases = (("float64", torch.float64, None),
             ("float32", torch.float32, None),
             ("bf16", torch.float64, torch.bfloat16))
    for key, dtype, pdt in cases:
        dname = str(dtype).replace("torch.", "")
        for local, (tiles, params_t, free_t, packed, _) in layouts.items():
            b = max(tiles.buckets, key=lambda bb: bb.cell.numel())
            if local and not b.loc:
                raise AssertionError("the windowed scene lost its locality")
            Nb, W = b.cell.shape
            off = sum(bb.cell.shape[0] for bb in
                      tiles.buckets[:tiles.buckets.index(b)])
            la = lin_args(b, params_t.points[off:off + Nb],
                          free_t[off:off + Nb], packed, dtype, local)
            bins = b.bins
            lin = lambda: k.tile_linearize_local(*la, plane_dtype=pdt,
                                                 bins=bins)
            lin_plain = lambda: k.tile_linearize_local_plain(
                *la, plane_dtype=pdt)
            cost, pout, r_t, jx_t, jcam_t, gc, hc = lin()
            if local:
                # the split first: in full runs the profiler has come back
                # empty, or without one of the passes, after the plain
                # version's long runs; a profile counts only with both
                split = dict.fromkeys(("linearize_rows", "linearize_bins",
                                       "other"), 0.0)
                times = next((t for t in (device_ms(lin) for _ in range(3))
                              if all(any(p in n for n in t)
                                     for p in list(split)[:2])), {})
                for kname, ms in times.items():
                    split[next((p for p in split if p in kname),
                               "other")] += ms
                in_bytes = nbytes(*la)
                measure(records, "tile_linearize_local", dname, lin, lin_plain,
                        lin_labels, args.reps,
                        in_bytes + nbytes(pout, r_t, jx_t, jcam_t, gc, hc),
                        W * Nb * OPS_PER_SLOT["tile_linearize_local"],
                        tol_name=key)
                records["tile_linearize_local"][key]["split_ms"] = split
                print(f"  tile_linearize_local {key:15s} by device time: "
                      + (f"row pass {split['linearize_rows']:.3f} ms, bin "
                         f"pass {split['linearize_bins']:.3f} ms "
                         f"({b.bins.runs.numel() - 1} blocks), the rest "
                         f"{split['other']:.3f} ms" if times else
                         "not measured (the profiler saw no device time)"))
            hpp = pout[3:12].T.reshape(Nb, 3, 3)
            binv_t = inv3x3(hpp + 0.1 * torch.eye(3, dtype=dtype,
                                                  device="cuda"))
            binv_t = binv_t.reshape(Nb, 9).T.contiguous()
            gp_t = pout[0:3].contiguous()
            V = tiles.cells.cols.shape[0]
            v_cells = torch.randn((V, 18), dtype=dtype, device="cuda",
                                  generator=rng)
            kw = dict(bins=bins)
            if local:
                cc = b.loc[1].long()
                v_arg = v_cells[cc].transpose(1, 2).contiguous()
                cell_t, name = b.loc[0].T.contiguous(), "tile_sweep_local"
                kern, plain = k.tile_sweep_local, k.tile_sweep_local_plain
                # the chunk-sorted copy of the stored planes, as the solver
                # builds it once per LM step; it must equal the plain
                # version's bits, or the row and bin passes would apply two
                # different E
                sort = lambda: k.sort_jcam_planes(jcam_t, bins, cc.shape[0])
                kw["sorted_jcam"] = sort()
                equal = torch.equal(kw["sorted_jcam"], k.sort_jcam_planes_plain(
                    jcam_t, bins, cc.shape[0]))
                if not equal:
                    raise AssertionError(f"sort_jcam_planes {key}: the copy "
                                         f"differs from its plain version's")
                sort_ms = time_ms(sort, args.reps)
                gbytes = nbytes(kw["sorted_jcam"]) / 1e9
                records.setdefault(name, {})[f"{key}:sorted_copy"] = dict(
                    ms=sort_ms, gbytes=gbytes, equal_to_plain=equal)
                print(f"  {name:22s} {key:15s} chunk-sorted copy of the "
                      f"{jcam_t.dtype} planes, {gbytes:.3f} GB, equal to the "
                      f"plain version's bits, built in {sort_ms:.3f} ms")
                # the fixed-order sums of the chunk bins into the V cells:
                # the sweep's (F = 18) and the linearize's (gc, F = 18; hc,
                # F = 171)
                part = kern(cell_t, jcam_t, jx_t, binv_t, gp_t, v_arg, **kw)
                for label, bins_out in (("sweep bins", part),
                                        ("linearize gc", gc),
                                        ("linearize hc", hc)):
                    check_sum(sums, f"{key}:{label}", dname, key,
                              lambda: k.sum_chunk_bins(bins_out, cc, V, bins),
                              bins_out.reshape(-1, bins_out.shape[-1]), cc,
                              V, args.reps)
                del part, bins_out
            else:
                v_arg, cell_t, name = v_cells, b.cell.T.contiguous(), \
                    "tile_sweep"
                kern, plain = k.tile_sweep, k.tile_sweep_plain
                # the cell-sorted jcam copy, built as the solver builds it
                # once per LM step: from the (Nb, W, 2, 18) slot rows in the
                # working dtype, unrounded, stored in the planes' dtype; it
                # must equal the plain version's bits, rounding included, or
                # the row and bin passes would apply two different E
                work = jcam_t if pdt is None else k.tile_linearize_local(
                    *la, bins=bins)[4]
                rows = work.view(W, 2, 18, Nb).permute(3, 0, 1, 2)
                rows = rows.contiguous()
                del work
                sort = lambda: k.sort_jcam(rows, bins, jcam_t.dtype)
                kw["sorted_jcam"] = sort()
                equal = torch.equal(kw["sorted_jcam"], k.sort_jcam_plain(
                    rows, bins, jcam_t.dtype))
                if not equal:
                    raise AssertionError(f"sort_jcam {key}: the copy differs "
                                         f"from sort_jcam_plain's")
                sort_ms = time_ms(sort, args.reps)
                records.setdefault(name, {})[f"{key}:sorted_copy"] = dict(
                    ms=sort_ms, gbytes=nbytes(kw["sorted_jcam"]) / 1e9,
                    equal_to_plain=equal)
                print(f"  {name:22s} {key:15s} sorted jcam copy from "
                      f"{rows.dtype} rows, "
                      f"{nbytes(kw['sorted_jcam']) / 1e9:.3f} GB, equal to "
                      f"the plain version's bits, built in {sort_ms:.3f} ms")
                del rows
            sw = (cell_t, jcam_t, jx_t, binv_t, gp_t, v_arg)
            plane_bytes = nbytes(cell_t, jcam_t, jx_t)
            for mode in ("rhs", "matvec", "edot"):
                out = kern(*sw, mode=mode, **kw)
                moved = (plane_bytes + nbytes(out)
                         + (nbytes(binv_t) if mode != "edot" else 0)
                         + (nbytes(gp_t) if mode == "rhs" else nbytes(v_arg)))
                del out
                measure(records, name, dname,
                        lambda: kern(*sw, mode=mode, **kw),
                        lambda: plain(*sw, mode=mode),
                        (mode,), args.reps, moved,
                        W * Nb * OPS_PER_SLOT[mode], tol_name=key,
                        mode=mode)
            del la, cost, pout, r_t, jx_t, jcam_t, gc, hc, sw, kw
            torch.cuda.empty_cache()
    for key, dtype in (("float64", torch.float64),
                       ("float32", torch.float32)):
        step_sums(layouts, key, dtype, sums, args.reps)
    print("[phase 6b] where one tile LM step's time goes")
    per_step = tile_step_breakdown(layouts[True])
    print("[phase 6c] one tile LM step on the locality=False layout "
          "(the tile_sweep path)")
    per_step.update(tile_global_step_split(layouts[False]))
    local = layouts[True]
    del layouts
    torch.cuda.empty_cache()
    return data, per_step, sums, local, bal_s


def phase_tile_global(args):
    """Phase 8: a few LM steps of solve_ba_tiles on the global cell table.
    Returns tile_sweep's launches in that solve alone."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.io import make_bal_windowed_host
    from deeparc_tpu_torch.residuals.reprojection import cost
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.tiles import solve_ba_tiles

    data = make_bal_windowed_host(n_points=args.global_points, seed=1,
                                  **TILE_SCENE)
    scene = from_deeparc(data, dtype=torch.float64, device="cuda")
    free = freeze_masks(scene)
    cost0 = float(cost(scene.params, scene.index))
    opts = SolverOptions(linear_solver="iterative_schur", cg_max_iterations=30,
                         max_iterations=3)
    k.reset_launch_counts()
    res = solve_ba_tiles(scene, free, opts, locality=False)
    torch.cuda.synchronize()
    launches = k.tile_sweep.launches
    print(f"  {data.n_points} points, locality=False: cost {cost0:.6e} -> "
          f"{res.cost:.6e} in {res.iterations} LM iterations "
          f"({res.cg_iterations} CG), {res.seconds:.3f} s; tile_sweep "
          f"launches {launches}, sorted jcam copies {k.sort_jcam.launches}")
    if k.sort_jcam.launches < res.iterations:
        raise AssertionError("tile_sweep's sorted jcam copy was not built "
                             "on the card")
    if not res.cost < cost0:
        raise AssertionError("solve_ba_tiles(locality=False) did not lower "
                             "the cost")

    # every routing of the step on a small scene with several bucket widths
    # (fused linearize for W <= 32, the torch chunk path with kernel sweeps
    # above), solved on the card and through the plain versions on the CPU
    from deeparc_tpu_torch.io import make_bal_synthetic
    from deeparc_tpu_torch.solver.tiles import tiles_from_scene

    mixed = make_bal_synthetic(n_cameras=64, n_points=3000, track_length=24,
                               pixel_noise=1.0, point_noise=0.02, seed=3).data
    opts = SolverOptions(linear_solver="iterative_schur", cg_max_iterations=30,
                         max_iterations=5)
    costs = {}
    for dev in ("cuda", "cpu"):
        scene = from_deeparc(mixed, dtype=torch.float64, device=dev)
        free = freeze_masks(scene)
        if dev == "cuda":
            tiles, _, _ = tiles_from_scene(scene, free)
            print(f"  mixed-width scene: {mixed.n_obs} observations, widths "
                  f"{[b.cell.shape[1] for b in tiles.buckets]}, locality "
                  f"{[bool(b.loc) for b in tiles.buckets]}")
        costs[dev] = solve_ba_tiles(scene, free, opts).cost
    rel = abs(costs["cuda"] - costs["cpu"]) / costs["cpu"]
    print(f"  mixed-width scene after 5 LM iterations: cost on the card "
          f"{costs['cuda']:.9e}, plain on the CPU {costs['cpu']:.9e}, "
          f"relative difference {rel:.3e} (tol 1e-6)")
    if not rel < 1e-6:
        raise AssertionError("the card's tile solve disagrees with the CPU's")
    return launches


def phase_probes(args, records):
    """Phase 9: the two measurement probes at the scripts' full shapes,
    each against its plain version (``fma_pass`` in float32 and float64,
    ``sweep_payload`` in float32 in both modes, with one batched
    ``torch.matmul`` as its library time), then their entry points'
    measurements with the counts set to 0 just before. Returns the probes'
    launches in the entry points' run."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.kernels import probes as kp
    from deeparc_tpu_torch.scripts import microbench_sweep_payload as msp
    from deeparc_tpu_torch.scripts import vpu_roofline as vr

    print("[phase 9] the measurement probes vs plain versions on the card")
    t0 = time.time()
    dev = torch.device("cuda")
    for dname, dtype in vr.DTYPES.items():
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.rand((kp.FMA_ROWS, kp.FMA_COLS * kp.FMA_TILES), dtype=dtype,
                       device=dev, generator=gen) * 2 - 1
        measure(records, "fma_pass", dname, lambda: kp.fma_pass(x),
                lambda: kp.fma_pass_plain(x), ("out",), args.reps,
                2 * nbytes(x), kp.fma_ops(x.numel()))
        del x
    # the library call: one batched product of the tile views in full
    # float32 (no TF32, which keeps about three decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    T = kp.PAYLOAD_TILES
    a, b = msp.payload_inputs(T, dev)
    at = a.view(kp.VL, T, kp.DEPTH).permute(1, 0, 2)
    bt = b.view(kp.P, T, kp.DEPTH).permute(1, 2, 0)
    library_ms = time_ms(lambda: torch.matmul(at, bt), args.reps)
    for mode in ("many", "one"):
        moved = nbytes(a, b) + 4 * T * kp.VL * kp.P
        measure(records, "sweep_payload", "float32",
                lambda: kp.sweep_payload(a, b, mode),
                lambda: kp.sweep_payload_plain(a, b, mode), (mode,),
                args.reps, moved, kp.payload_ops(T), mode=mode)
        records["sweep_payload"][f"float32:{mode}"]["library_ms"] = library_ms
    last = kp.sweep_payload(a, b, "many")[-1]
    want = a[:, -kp.DEPTH:] @ b[:, -kp.DEPTH:].T
    rel = float((last - want).abs().max() / want.abs().max())
    print(f"  sweep_payload: batched torch.matmul (TF32 off) {library_ms:.3f} "
          f"ms; the last tile, the Pallas probe's whole output, within "
          f"{rel:.3e} of a @ b.T")
    if not rel < TOLERANCE["float32"]:
        raise AssertionError("sweep_payload's last tile disagrees")
    del a, b, at, bt, last, want
    torch.cuda.empty_cache()

    # the entry points, as a user runs them
    cut = "" if args.dense_points == vr.DENSE_POINTS else (
        f" (n_points cut from {vr.DENSE_POINTS} to {args.dense_points})")
    k.reset_launch_counts()
    roof = vr.run("cuda", args.dense_points)
    payload = msp.run("cuda")
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in k.PROBE_WRAPPERS}
    print(f"  vpu_roofline{cut}: {json.dumps(roof)}")
    print(f"  microbench_sweep_payload: {json.dumps(payload)}")
    for sfx in ("f32", "f64"):
        print(f"  FMA ceiling {sfx}: {roof['fma_peak_tflops_' + sfx]:.3f} "
              f"TFLOP/s, {roof['fma_vs_published_peak_' + sfx]:.3f} of the "
              f"published peak; dense linearize_grid "
              f"{roof['dense_lin_ms_' + sfx]:.3f} ms, "
              f"{roof['dense_lin_tflops_' + sfx]:.3f} TFLOP/s over "
              f"{roof['dense_live_slots']} live slots, "
              f"{roof['dense_lin_vs_fma_peak_' + sfx]:.4f} of the ceiling, "
              f"{roof['dense_lin_vs_published_peak_' + sfx]:.4f} of the "
              f"published peak")
    print(f"  launches of the probes in their entry points: {launches}; "
          f"phase 9 took {time.time() - t0:.1f} s")
    return launches, {"vpu_roofline": roof, "microbench_sweep_payload": payload}


# ---------------------------------------------------------------------------
# Indexed engine, incremental BA, checkpoint/resume (phases 10-12)
# ---------------------------------------------------------------------------

# the windowed BAL scene of phase 11's pose-graph run: fewer cameras than
# phase 6's 2000 keep the phase short (the benchmark's bal-venice.incremental
# runs the pose graph at 1,778 cameras)
POSE_SCENE = dict(n_cameras=128, track_length=8, window=64, n_hubs=8,
                  hub_frac=0.15, pixel_noise=PIXEL_NOISE, point_noise=0.02)
# LM iterations a solve: phase 10's indexed pipeline (it converges in ~5 on
# the flagship), phase 11's incremental batches (5 left the last batches
# unconverged: RMSE 3.1 px)
INDEXED_ITERATIONS = 10
INCREMENTAL_ITERATIONS = 20


def check_state_repeats(run, label):
    """One indexed LM step run twice from one state gives the same bits in
    the next state's parameters and cost."""
    import dataclasses

    import torch

    a, b = run()[0], run()[0]
    for f in dataclasses.fields(a.params):
        if not torch.equal(getattr(a.params, f.name),
                           getattr(b.params, f.name)):
            raise AssertionError(f"{label}, run twice: different bits in "
                                 f"{f.name}")
    if not torch.equal(a.cost, b.cost):
        raise AssertionError(f"{label}, run twice: different bits in cost")


def indexed_sums(index, maps, N, R, K, reps):
    """The indexed step's fixed-order row sums against ``index_add_`` on the
    card, through the solve's own maps (``solver.schur.schur_maps``), on
    values made from a seed: the point sums (F = 12), an extrinsic camera
    group (F = 6, segmented), E's full grid of one group (F = 18) and one
    Hcc block pair (F = 36, segmented)."""
    import torch

    from deeparc_tpu_torch.kernels import tile as k

    gen = torch.Generator(device="cuda").manual_seed(4)
    M = index.obs_point.shape[0]
    rand = lambda F: torch.randn((M, F), dtype=torch.float64, device="cuda",
                                 generator=gen)
    op, oo = index.obs_point.long(), index.obs_outer.long()
    cases = (("points", 12, op, N, maps.point),
             ("outer group", 6, oo, R, maps.outer),
             ("E grid, outer group", 18, op * R + oo, N * R, maps.dense_e[0]),
             ("Hcc outer x outer", 36, oo * R + oo, R * R, maps.hcc[0]))
    sums: dict = {}
    for label, F, dst, n_out, gmap in cases:
        part = rand(F)
        check_sum(sums, f"float64:{label}", "float64", None,
                  lambda: k.sum_rows(part, dst, n_out, gmap), part, dst,
                  n_out, reps)
        del part
    return sums


def indexed_step_split(data, reps):
    """Phase 10a: one LM step of the indexed engine (float64, DENSE_SCHUR,
    the pipeline's full-BA free mask) on the occlusion flagship: host wall
    time around the synchronised step; the Jacobian blocks
    (``jacobian_blocks_flat``), ``build_system``, ``solve_schur`` and the
    trial cost (``robust_cost``) timed alone with CUDA events (the rest:
    J dx, the step's update); the idle share over one profiled step
    (:func:`step_profile`); ``sum_rows`` launches in one step; the step run
    twice must give the same bits. Then one ITERATIVE_SCHUR step (30 PCG
    iterations).
    Returns the record."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.residuals.reprojection import (
        flatten_camera,
        jacobian_blocks_flat,
    )
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.ba import (
        init_state,
        make_step_pure,
        robust_cost,
    )
    from deeparc_tpu_torch.solver.schur import (
        build_system,
        schur_maps,
        solve_schur,
    )

    scene = from_deeparc(data, dtype=torch.float64, device="cuda")
    free = freeze_masks(scene)
    params, index = scene.params, scene.index
    N, R, K = (params.points.shape[0], params.ext_rot.shape[0],
               params.center.shape[0])
    cam_free, pf = flatten_camera(free), free.points
    torch.cuda.synchronize()
    t0 = time.time()
    maps = schur_maps(index, N, R, K)
    torch.cuda.synchronize()
    maps_ms = (time.time() - t0) * 1e3
    print(f"  {index.obs_point.shape[0]} observations, {N} points, camera "
          f"vector C = {6 * (R + K)}; the solve's row-sum maps, built once "
          f"per solve: {maps_ms:.1f} ms")
    rec = {"maps_build_ms": maps_ms}
    for solver, cg in (("dense_schur", None), ("iterative_schur", 30)):
        opts = SolverOptions(linear_solver=solver,
                             **({"cg_max_iterations": cg} if cg else {}))
        step = make_step_pure(opts)
        state = init_state(params, index, opts)
        m = maps if solver == "dense_schur" else maps._replace(dense_e=(),
                                                               hcc=())
        run = lambda: step(state, index, cam_free, pf, m)
        k.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        launches = k.sum_rows.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        wall = wall_ms(run, 3)
        blocks = jacobian_blocks_flat(params, index)
        sys = build_system(blocks.r, blocks.jp, blocks.jc, index, N, R, K,
                           cam_free, pf, m)
        parts = {
            "jacobian": time_ms(lambda: jacobian_blocks_flat(params, index),
                                3),
            "build_system": time_ms(lambda: build_system(
                blocks.r, blocks.jp, blocks.jc, index, N, R, K, cam_free, pf,
                m), 3),
            "solve_schur": time_ms(lambda: solve_schur(
                sys, state.tr.radius, opts), 3),
            "trial cost": time_ms(lambda: robust_cost(params, index, opts),
                                  3)}
        del blocks, sys
        _, busy, window = step_profile(run)
        label = f"one indexed LM step ({solver}{f', {cg} PCG' if cg else ''})"
        print_split(label, wall, parts, busy, window)
        print(f"  sum_rows launches in one step: {launches}; peak device "
              f"memory {peak:.2f} GiB")
        check_state_repeats(run, label)
        print("  the step run twice: the same bits")
        rec[solver] = dict(wall_ms=wall, device_ms=busy, window_ms=window,
                           idle_share=idle_share(busy, window),
                           sum_rows_launches=launches, peak_gib=peak, **parts)
        del state
        torch.cuda.empty_cache()
    rec["sum_rows"] = indexed_sums(index, maps, N, R, K, reps)
    return rec


def phase_indexed(args, data):
    """Phase 10: the indexed engine at full size (the step split, then
    ``run_pipeline(engine="indexed")`` with the LM iterations capped);
    returns its record."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import PipelineOptions, SolverOptions
    from deeparc_tpu_torch.pipeline import run_pipeline

    print("[phase 10] the indexed engine on the occlusion flagship, float64")
    t0 = time.time()
    rec = indexed_step_split(data, args.reps)
    opts = PipelineOptions(
        solver=SolverOptions(max_iterations=INDEXED_ITERATIONS),
        write_snapshots=False, engine="indexed")
    k.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    res = run_pipeline(data, opts, device="cuda", dtype=torch.float64,
                       verbose=True)
    torch.cuda.synchronize()
    seconds = time.time() - t1
    launches = k.sum_rows.launches
    per_iter = res.solve_seconds / max(res.solve_iterations, 1)
    print(f"  run_pipeline(engine='indexed'): rounds {res.filter_rounds}, "
          f"points {res.scene.n_points}, final_rmse_px "
          f"{res.final_rmse_px:.6f}, LM iterations {res.solve_iterations} "
          f"(at most {INDEXED_ITERATIONS} a solve), {per_iter:.6f} "
          f"s/iteration, pipeline {seconds:.3f} s, sum_rows launches "
          f"{launches}; phase 10 took {time.time() - t0:.1f} s")
    if launches <= 0:
        raise AssertionError("the indexed engine launched no sum_rows")
    if not res.final_rmse_px < 2 * PIXEL_NOISE:
        raise AssertionError(f"indexed pipeline: final RMSE "
                             f"{res.final_rmse_px} px not under "
                             f"{2 * PIXEL_NOISE} px")
    rec["pipeline"] = dict(rounds=res.filter_rounds,
                           final_rmse_px=res.final_rmse_px,
                           lm_iterations=res.solve_iterations,
                           s_per_iteration=per_iter, seconds=seconds,
                           sum_rows_launches=launches)
    return rec


def check_incremental(inc, label):
    import math

    costs = [h["cost"] for h in inc.history]
    print(f"  {label}: {inc.batches} batches, per-batch cost "
          + ", ".join(f"{c:.6e}" for c in costs) + ", iterations "
          + str([h["iterations"] for h in inc.history])
          + f"; final_rmse_px {inc.final_rmse_px:.6f}")
    if not all(math.isfinite(c) for c in costs):
        raise AssertionError(f"{label}: a batch cost is not finite")
    if not inc.final_rmse_px < 2 * PIXEL_NOISE:
        raise AssertionError(f"{label}: final RMSE {inc.final_rmse_px} px "
                             f"not under {2 * PIXEL_NOISE} px")


def phase_incremental(args, data):
    """Phase 11: BFS incremental BA on the card. The shared flagship on the
    grid engine (one ring of 24 cells a batch, 8 batches); then a windowed
    BAL scene of 128 cameras on the tile engine with the pose-graph stage.
    Returns its record."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import PipelineOptions, SolverOptions
    from deeparc_tpu_torch.io import make_bal_windowed_host
    from deeparc_tpu_torch.pipeline.incremental import run_incremental

    print("[phase 11] BFS incremental BA, float64")
    rec = {}
    opts = PipelineOptions(solver=SolverOptions(
        max_iterations=INCREMENTAL_ITERATIONS))
    k.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    inc = run_incremental(data, opts, batch_size=24, device="cuda",
                          verbose=True)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in k.KERNEL_WRAPPERS
                if fn.launches}
    print(f"  occlusion flagship, run_incremental (batch 24 cells, at most "
          f"{INCREMENTAL_ITERATIONS} LM iterations a solve): "
          f"{seconds:.3f} s; kernel launches per batch "
          + str({kn: n / inc.batches for kn, n in launches.items()}))
    check_incremental(inc, "grid incremental")
    for kname in ("linearize_grid_banded", "cost_grid_banded"):
        if not launches.get(kname):
            raise AssertionError(f"run_incremental launched no {kname}")
    rec["grid"] = dict(batches=inc.batches, seconds=seconds,
                       final_rmse_px=inc.final_rmse_px,
                       costs=[h["cost"] for h in inc.history],
                       launches=launches)

    C = POSE_SCENE["n_cameras"]
    bal = make_bal_windowed_host(n_points=args.global_points, seed=1,
                                 **POSE_SCENE)
    opts = PipelineOptions(solver=SolverOptions(
        linear_solver="iterative_schur", cg_max_iterations=30,
        max_iterations=INCREMENTAL_ITERATIONS))
    k.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    inc = run_incremental(bal, opts, device="cuda", verbose=True,
                          pose_graph=True)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {fn.__name__: fn.launches for fn in k.KERNEL_WRAPPERS
                if fn.launches}
    print(f"  windowed BAL scene, {C} cameras (cut from phase 6's 2000), "
          f"{bal.n_points} points, "
          f"{bal.n_obs} observations, run_incremental_free with the pose "
          f"graph: {seconds:.3f} s, peak device memory {peak:.2f} GiB; "
          f"kernel launches per batch "
          + str({kn: n / inc.batches for kn, n in launches.items()}))
    check_incremental(inc, "free incremental with the pose graph")
    if not launches.get("tile_linearize_local"):
        raise AssertionError("run_incremental_free launched no tile kernel")
    rec["free"] = dict(cameras=C, batches=inc.batches, seconds=seconds,
                       final_rmse_px=inc.final_rmse_px, peak_gib=peak,
                       costs=[h["cost"] for h in inc.history],
                       launches=launches)
    return rec


def phase_resume(args, data):
    """Phase 12: checkpoint/resume on the card. For ``solve_ba_grid`` (the
    banded flagship), ``solve_tiles_prepared`` (phase 8's windowed BAL
    scene) and ``solve_ba`` (the flagship's observation list): k = 3
    iterations (fewer if the solve converges by then) with
    ``checkpoint_every=k`` and a ``JsonlLogger``, resumed to 6, against an
    uninterrupted 6-iteration solve: the final costs
    within 1e-12 relative (whether the bits match is printed); the log
    holds one ``lm_iteration`` line per iteration."""
    import dataclasses
    import os
    import shutil

    import torch

    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.io import make_bal_windowed_host
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.ba import solve_ba
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        solve_ba_grid,
    )
    from deeparc_tpu_torch.solver.tiles import (
        solve_tiles_prepared,
        tiles_from_scene,
    )
    from deeparc_tpu_torch.utils import JsonlLogger

    print("[phase 12] checkpoint/resume on the card, float64")
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_resume")
    os.makedirs(work, exist_ok=True)
    scene = from_deeparc(data, dtype=torch.float64, device="cuda")
    free = freeze_masks(scene)
    grid = grid_from_scene(scene)
    bal = from_deeparc(make_bal_windowed_host(
        n_points=args.global_points, seed=1, **TILE_SCENE),
        dtype=torch.float64, device="cuda")
    bfree = freeze_masks(bal)
    tiles, params_t, free_t = tiles_from_scene(bal, bfree)
    bcam = flatten_camera(bfree)
    tile_opts = dict(linear_solver="iterative_schur", cg_max_iterations=30)
    solvers = {
        "solve_ba_grid": (lambda o, **kw: solve_ba_grid(
            scene.params, grid, free, o, **kw), {}),
        "solve_tiles_prepared": (lambda o, **kw: solve_tiles_prepared(
            params_t, tiles, free_t, bcam, o, **kw), tile_opts),
        "solve_ba": (lambda o, **kw: solve_ba(
            scene.params, scene.index, free, o, **kw), {}),
    }
    rec = {}
    for name, (solve, extra) in solvers.items():
        path = os.path.join(work, f"{name}.npz")
        log_path = os.path.join(work, f"{name}.jsonl")
        for p in (path, log_path):
            if os.path.exists(p):
                os.remove(p)
        full = solve(SolverOptions(max_iterations=6, **extra))
        # stop before the uninterrupted solve converges: a resumed solve
        # starts with its status cleared, as the reference's does
        k = min(3, full.iterations - 1)
        if k < 1:
            raise AssertionError(f"{name}: converged in one iteration")
        with JsonlLogger(log_path) as logger:
            first = solve(SolverOptions(max_iterations=k, **extra),
                          checkpoint_path=path, checkpoint_every=k,
                          logger=logger)
        resumed = solve(SolverOptions(max_iterations=6, **extra),
                        checkpoint_path=path, checkpoint_every=100,
                        resume=True)
        lines = [ln for ln in open(log_path) if '"lm_iteration"' in ln]
        rel = abs(resumed.cost - full.cost) / abs(full.cost)
        same = resumed.cost == full.cost and all(
            torch.equal(getattr(resumed.params, f.name),
                        getattr(full.params, f.name))
            for f in dataclasses.fields(full.params))
        print(f"  {name}: uninterrupted {full.iterations} iterations, cost "
              f"{full.cost:.12e}; {k} + resumed to {resumed.iterations}: "
              f"{resumed.cost:.12e}, relative difference {rel:.3e} (tol "
              f"1e-12), same bits: {same}; log lines {len(lines)} for "
              f"{first.iterations} iterations")
        if resumed.iterations != full.iterations or not rel <= 1e-12:
            raise AssertionError(f"{name}: the resumed solve did not end "
                                 f"where the uninterrupted one did")
        if len(lines) != first.iterations:
            raise AssertionError(f"{name}: {len(lines)} lm_iteration lines "
                                 f"for {first.iterations} iterations")
        rec[name] = dict(cost=full.cost, resumed_cost=resumed.cost,
                         rel_diff=rel, same_bits=same,
                         iterations=full.iterations)
    shutil.rmtree(work, ignore_errors=True)
    return rec


# ---------------------------------------------------------------------------
# The sharded engines (phase 13)
# ---------------------------------------------------------------------------

# LM iterations a solve of the tiles-sharded pipeline (phase 7's scene; the
# pipeline's layout build and its rounds must fit the script's time)
TILES_SHARDED_ITERATIONS = 10
# LM iterations of each solve of the two-rank runs (13d)
TWO_RANK_ITERATIONS = {"grid": 10, "tiles": 5, "indexed": 5}


def timed_reducer():
    """A ``Reducer`` over the current group that times its all_reduce calls
    with CUDA events (``ms()``, since the last ``reset()``)."""
    import torch

    from deeparc_tpu_torch.parallel.multihost import Reducer

    class Timed(Reducer):
        def reset(self):
            self.events, self.bytes, self.calls = [], 0, 0

        def _reduce(self, x, op):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = super()._reduce(x, op)
            ev[1].record()
            self.events.append(ev)
            return out

        def ms(self):
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.events)

    red = Timed()
    red.reset()
    return red


def sharded_step_split(data):
    """13c: one sharded LM step at one rank (NCCL) on phase 3b's
    uniform-random rig with its inputs: split as phase 3b splits it, plus
    the collectives by CUDA events (calls, bytes, ms, share of the step);
    run twice for the same bits, and the same bits as phase 3b's unsharded
    step in points, camera vector and cost. Returns the record."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.rig_grid import (
        assemble_grid_system,
        grid_cost,
        grid_from_scene,
        init_grid_state,
        make_grid_step,
        mono_stack,
        slot_params,
    )

    scene = from_deeparc(data, dtype=torch.float64, device="cuda")
    grid = grid_from_scene(scene)
    free = freeze_masks(scene)
    cam_free = flatten_camera(free)
    params = scene.params
    opts = SolverOptions()
    pxm = mono_stack(grid, (256, 1024))
    red = timed_reducer()
    step = make_grid_step(opts, params, pxm=pxm, reducer=red)
    state = init_grid_state(params, grid, opts, pxm=pxm, reducer=red)
    run = lambda: step(state, grid, cam_free, free.points)
    unsharded = make_grid_step(opts, params, pxm=pxm)(
        init_grid_state(params, grid, opts, pxm=pxm), grid, cam_free,
        free.points)[0]
    red.reset()
    got = run()[0]
    torch.cuda.synchronize()
    coll = dict(calls=red.calls, bytes=red.bytes, ms=red.ms())
    for field in ("points", "cam_vec", "cost"):
        if not torch.equal(getattr(got, field), getattr(unsharded, field)):
            raise AssertionError(f"the one-rank sharded step and phase 3b's "
                                 f"step differ in {field}")
    print("  the one-rank sharded step and phase 3b's unsharded step: the "
          "same bits in points, camera vector and cost")
    sp = slot_params(params, grid)
    wall = wall_ms(run, 3)
    per_step = split_grid_step(
        "one sharded LM step (f64, one rank, NCCL) on the uniform rig", run,
        (k.linearize_grid, k.cost_grid),
        lambda: assemble_grid_system(params.points, sp, grid, cam_free,
                                     free.points, pxm=pxm),
        lambda: grid_cost(params.points, sp, grid, pxm=pxm))
    C = cam_free.shape[0]
    print(f"  collectives of one step: {coll['calls']} all_reduce calls, "
          f"{coll['bytes']} bytes handed to them (C = {C}), "
          f"{coll['ms']:.3f} ms by CUDA events, "
          f"{coll['ms'] / wall:.4f} of the step's {wall:.3f} ms wall")
    return dict(wall_ms=wall, collective_calls=coll["calls"],
                collective_bytes=coll["bytes"], collective_ms=coll["ms"],
                collective_share=coll["ms"] / wall, C=C,
                launches_per_step=per_step)


def sharded_runs(flagship, tile_data):
    """The three sharded solves of 13d in the current group, on the card:
    ``solve_ba_grid_sharded`` on the flagship, ``solve_ba_tiles_sharded``
    on the ``locality=False`` layout of phase 8's scene and
    ``solve_ba_sharded`` on the flagship, the LM iterations capped
    (``TWO_RANK_ITERATIONS``). Returns {solve: numpy results} and the
    kernels' launches."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.parallel import shard_scene, solve_ba_sharded
    from deeparc_tpu_torch.parallel.sharded_grid import solve_ba_grid_sharded
    from deeparc_tpu_torch.parallel.sharded_tiles import (
        solve_ba_tiles_sharded,
    )
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.rig_grid import grid_from_scene
    from deeparc_tpu_torch.solver.tiles import tiles_from_scene

    np_of = lambda t: t.detach().cpu().numpy()
    out = {}
    k.reset_launch_counts()
    scene = from_deeparc(flagship, dtype=torch.float64, device="cuda")
    free = freeze_masks(scene)
    t0 = time.time()
    res = solve_ba_grid_sharded(
        scene.params, grid_from_scene(scene), free,
        SolverOptions(max_iterations=TWO_RANK_ITERATIONS["grid"]))
    out["grid"] = dict(points=np_of(res.params.points),
                       cam_vec=np_of(flatten_camera(res.params)),
                       cost=res.cost, iterations=res.iterations,
                       seconds=time.time() - t0)
    t0 = time.time()
    res = solve_ba_sharded(
        shard_scene(scene, free, torch.distributed.get_world_size()),
        SolverOptions(max_iterations=TWO_RANK_ITERATIONS["indexed"]),
        device=scene.params.points.device)
    out["indexed"] = dict(points=np_of(res.points).reshape(-1, 3)[
        :scene.n_points], cam_vec=np_of(res.cam_vec),
                          cost=float(res.cost), iterations=res.iterations,
                          seconds=time.time() - t0)
    del scene, free, res
    torch.cuda.empty_cache()
    scene = from_deeparc(tile_data, dtype=torch.float64, device="cuda")
    free = freeze_masks(scene)
    tiles, params_t, free_t = tiles_from_scene(scene, free, locality=False)
    t0 = time.time()
    res = solve_ba_tiles_sharded(
        params_t, tiles, free_t, flatten_camera(free), SolverOptions(
            linear_solver="iterative_schur", cg_max_iterations=30,
            max_iterations=TWO_RANK_ITERATIONS["tiles"]))
    out["tiles"] = dict(points=np_of(res.params.points),
                        cam_vec=np_of(flatten_camera(res.params)),
                        cost=res.cost, iterations=res.iterations,
                        seconds=time.time() - t0)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in k.KERNEL_WRAPPERS}
    return out, launches


def _two_rank_main(rank, n, rdv, out_path, flagship, tile_data):
    """One rank of 13d's gloo group, both ranks on ``cuda:0``."""
    import pickle

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}",
                            world_size=n, rank=rank)
    try:
        res = sharded_runs(flagship, tile_data)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def two_ranks_on_the_card(flagship, tile_data, work):
    """13d: the three sharded solves in a two-rank gloo group of spawned
    processes on ``cuda:0`` (NCCL refuses two ranks on one card) against
    the same solves at one rank (this process's group): iterations equal,
    cost rtol 1e-9, points and camera vector rtol 1e-7 / atol 1e-9.
    Returns the record and the one-rank run's launches."""
    import os
    import pickle

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    one, launches = sharded_runs(flagship, tile_data)
    torch.cuda.empty_cache()
    out_path = os.path.join(work, "two_ranks.pkl")
    t0 = time.time()
    mp.start_processes(_two_rank_main,
                       args=(2, os.path.join(work, "rdv"), out_path,
                             flagship, tile_data),
                       nprocs=2, join=True, start_method="spawn")
    seconds = time.time() - t0
    with open(out_path, "rb") as f:
        two, two_launches = pickle.load(f)
    rec = {}
    for name in ("grid", "indexed", "tiles"):
        a, b = one[name], two[name]
        d_pts = float(np.max(np.abs(a["points"] - b["points"])))
        rel_cost = abs(a["cost"] - b["cost"]) / abs(a["cost"])
        print(f"  {name}: one rank {a['iterations']} iterations, cost "
              f"{a['cost']:.12e} ({a['seconds']:.3f} s); two ranks "
              f"{b['iterations']} iterations, cost {b['cost']:.12e} "
              f"({b['seconds']:.3f} s); relative cost difference "
              f"{rel_cost:.3e}, max point difference {d_pts:.3e}")
        if a["iterations"] != b["iterations"]:
            raise AssertionError(f"two ranks: {name} took another number "
                                 "of iterations")
        np.testing.assert_allclose(b["cost"], a["cost"], rtol=1e-9)
        for key in ("points", "cam_vec"):
            np.testing.assert_allclose(b[key], a[key], rtol=1e-7, atol=1e-9,
                                       err_msg=f"two ranks: {name} {key}")
        rec[name] = dict(iterations=a["iterations"], cost_one=a["cost"],
                         cost_two=b["cost"], rel_cost=rel_cost,
                         max_point_diff=d_pts, seconds_one=a["seconds"],
                         seconds_two=b["seconds"])
    print(f"  two-rank group (gloo, spawned, both on cuda:0): "
          f"{seconds:.1f} s with start-up; its rank 0's launches "
          f"{ {n: v for n, v in two_launches.items() if v} }")
    rec["two_rank_seconds"] = seconds
    rec["two_rank_launches"] = two_launches
    return rec, launches


def phase_sharded(args, flagship, uniform=None, tile_data=None):
    """Phase 13: the sharded engines on the card. (a) the grid-sharded
    pipeline on the flagship in a one-rank NCCL group (started by the
    pipeline), and its freeze-camera solve against ``solve_ba_grid`` on the
    monolithic route; (b) the tiles-sharded pipeline on phase 7's scene;
    (c) one sharded grid step (:func:`sharded_step_split`); (d) two ranks
    on the card (:func:`two_ranks_on_the_card`); (e)
    ``dryrun_multichip(1)``. Returns its record and the sharded paths'
    launches."""
    import dataclasses
    import os
    import shutil

    import torch
    import torch.distributed as dist

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.io import make_bal_windowed_host
    from deeparc_tpu_torch.parallel.dryrun import dryrun_multichip
    from deeparc_tpu_torch.parallel.sharded_grid import solve_ba_grid_sharded
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        solve_ba_grid,
    )

    print("[phase 13] the sharded engines on the card, float64")
    t0 = time.time()
    rec, launches = {}, {}
    uniform = uniform or flagship_rig(args.n_points, None, 1)
    tile_data = tile_data or make_bal_windowed_host(
        n_points=args.tile_points, seed=0, **TILE_SCENE)

    print("  (a) run_pipeline(engine='grid-sharded') on the occlusion "
          "flagship, one rank")
    k.reset_launch_counts()
    res = run_main_path(flagship, args, "grid-sharded pipeline",
                        engine="grid-sharded")
    grid_launches = {fn.__name__: fn.launches
                     for fn in (k.linearize_grid, k.cost_grid,
                                k.linearize_grid_banded, k.cost_grid_banded,
                                k.schur_reduce)}
    print(f"  launches: {grid_launches}; process group: "
          f"{dist.get_world_size()} rank, {dist.get_backend()}")
    launches.update({name: grid_launches[name]
                     for name in ("linearize_grid", "cost_grid",
                                  "schur_reduce")})
    rec["grid_pipeline"] = dict(
        rounds=res.filter_rounds, final_rmse_px=res.final_rmse_px,
        lm_iterations=res.solve_iterations, seconds=res.solve_seconds,
        s_per_iteration=res.solve_seconds / max(res.solve_iterations, 1))
    scene = from_deeparc(flagship, dtype=torch.float64, device="cuda")
    grid = grid_from_scene(scene)
    frozen = freeze_masks(scene, freeze_camera=True)
    frozen = dataclasses.replace(
        frozen, points=frozen.points * grid.point_mask[:, None])
    opts = SolverOptions(max_iterations=args.max_iterations)
    a = solve_ba_grid_sharded(scene.params, grid, frozen, opts)
    b = solve_ba_grid(scene.params, grid, frozen, opts,
                      band_reuse={"prep": None})
    rel = abs(a.cost - b.cost) / abs(b.cost)
    print(f"  freeze-camera solve: sharded (one rank) cost {a.cost:.12e} in "
          f"{a.iterations} iterations ({a.seconds:.3f} s), solve_ba_grid "
          f"monolithic {b.cost:.12e} in {b.iterations} ({b.seconds:.3f} s); "
          f"relative difference {rel:.3e} (tol 1e-9)")
    if not (rel < 1e-9 and a.iterations == b.iterations):
        raise AssertionError("the sharded freeze-camera solve disagrees "
                             "with solve_ba_grid")
    rec["freeze_solve"] = dict(cost_sharded=a.cost, cost_mono=b.cost,
                               rel=rel, iterations=a.iterations,
                               seconds_sharded=a.seconds,
                               seconds_mono=b.seconds)
    del scene, grid, frozen, a, b
    torch.cuda.empty_cache()

    print("  (b) run_pipeline(engine='tiles-sharded') on the windowed BAL "
          f"scene, at most {TILES_SHARDED_ITERATIONS} LM iterations a solve")
    k.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    res = run_main_path(tile_data, args, "tiles-sharded pipeline",
                        SolverOptions(linear_solver="iterative_schur",
                                      cg_max_iterations=30,
                                      max_iterations=TILES_SHARDED_ITERATIONS),
                        engine="tiles-sharded")
    tile_launches = {fn.__name__: fn.launches
                     for fn in (k.tile_linearize_local, k.tile_sweep_local)}
    print(f"  launches: {tile_launches}")
    launches.update(tile_launches)
    rec["tiles_pipeline"] = dict(
        rounds=res.filter_rounds, final_rmse_px=res.final_rmse_px,
        lm_iterations=res.solve_iterations, solve_seconds=res.solve_seconds,
        pipeline_seconds=time.time() - t1, cg_iterations=res.cg_iterations,
        s_per_iteration=res.solve_seconds / max(res.solve_iterations, 1))
    torch.cuda.empty_cache()

    print("  (c) one sharded grid step on the uniform-random rig")
    rec["step"] = sharded_step_split(uniform)
    torch.cuda.empty_cache()

    print("  (d) two ranks on the card")
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_two_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    global_data = make_bal_windowed_host(n_points=args.global_points, seed=1,
                                         **TILE_SCENE)
    rec["two_ranks"], one_launches = two_ranks_on_the_card(
        flagship, global_data, work)
    shutil.rmtree(work, ignore_errors=True)
    launches["tile_sweep"] = one_launches["tile_sweep"]
    torch.cuda.empty_cache()

    print("  (e) dryrun_multichip(1)")
    rec["dryrun"] = dryrun_multichip(1)
    dist.destroy_process_group()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the sharded "
                                 "paths")
    print(f"  launches on the sharded paths: {launches}; phase 13 took "
          f"{time.time() - t0:.1f} s")
    rec["launches"] = launches
    return rec, launches


# ---------------------------------------------------------------------------
# The on-device LM driver (phase 14)
# ---------------------------------------------------------------------------

# LM iterations and the block of phase 14's solves: (max_iterations,
# while_block) per case; the fused-trial solves take the grid's, the
# sharded ones theirs ("sharded tiles": phase 13d's 5 iterations)
DEVICE_LOOP_ITERATIONS = {"grid": (10, 5), "tiles": (6, 3), "indexed": (3, 3),
                          "sharded tiles": (5, 5)}
# hand kernels each case's graph must hold among its kernel nodes (and so
# launch in every replay); set_condition is the WHILE node's condition
# kernel. A fused-trial step launches no cost kernel: its trial evaluation
# is the linearize.
REPLAY_KERNELS = {
    "banded flagship": ("linearize_band", "cost_band", "schur_tiles",
                        "set_condition"),
    "monolithic uniform rig": ("linearize_mono", "cost_band", "schur_tiles",
                               "set_condition"),
    "banded flagship, fused": ("linearize_band", "schur_tiles",
                               "set_condition"),
    "monolithic uniform rig, fused": ("linearize_mono", "schur_tiles",
                                      "set_condition"),
    "windowed BAL scene": ("linearize_rows", "linearize_bins", "lsweep_bins",
                           "sort_planes", "gather_cells", "set_condition"),
    "indexed flagship": ("gather_cells", "set_condition"),
    "grid-sharded": ("linearize_mono", "cost_band", "schur_tiles",
                     "set_condition"),
    "tiles-sharded": ("gsweep_rows", "gsweep_bins", "sort_rows", "edot_rows",
                      "gather_cells", "set_condition"),
    "sharded indexed": ("gather_cells", "set_condition"),
}
# the parts of a grid LM step by kernel name: the linearize kernels, the
# cost pass, the select (torch.where; the classic step's small selects
# too), the Schur solve's reduction kernels and cuBLAS / cuSOLVER calls
# (products, Cholesky, triangular solves); every other kernel is "rest"
STEP_PARTS = (("linearize", ("linearize", "reduce_slots")),
              ("cost", ("cost_band", "reduce_cost")),
              ("select", ("where",)),
              ("schur", ("schur_tiles", "schur_sum_slices", "gemm", "gemv",
                         "cutlass", "trsv", "trf", "dot_kernel",
                         "splitKreduce", "reduce_1Block", "potrf", "trsm")))
# a fused-trial solve against the classic one: the same iterations, the
# final cost within this relative difference (their costs come from the
# linearize and the cost kernel, which sum in other orders)
FUSED_COST_RTOL = 1e-9


def busy_window(prof, graph):
    """(device busy ms, window ms, kernel names, gaps) over a solve's LM
    loop (the solvers' ``LM_LOOP`` range in the profile), all on the
    device's clock: the window runs from the first device activity that a
    runtime call of the loop launched (for the graph driver, its first
    graph launch) to the last one's end (``scripts.loop_window``, through
    the calls' correlation ids), busy is the union of the device's
    activities clipped to it (``scripts.busy_in``), gaps the window's
    largest idle stretches with the activities on either side; None when
    the profile holds no such range or launch."""
    from torch.autograd import DeviceType

    from deeparc_tpu_torch.solver.ba import LM_LOOP

    events = prof.events()
    loops = [e.time_range for e in events
             if e.name == LM_LOOP and e.device_type == DeviceType.CPU]
    if not loops:
        return None
    runtime = [(e.time_range.start, e.id, e.name) for e in events
               if e.device_type == DeviceType.CPU and e.name.startswith("cu")]
    acts = [(e.time_range.start, e.time_range.end, e.id, e.name)
            for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name != LM_LOOP]
    window = loop_window((loops[-1].start, loops[-1].end), runtime,
                         [a[:3] for a in acts],
                         "cudaGraphLaunch" if graph else None)
    if window is None:
        return None
    lo, hi = window
    busy = busy_in([(a, b) for a, b, _, _ in acts], lo, hi)
    kern = sorted((max(a, lo), min(b, hi), name) for a, b, _, name in acts
                  if b > lo and a < hi)
    gaps = sorted(((b[0] - a[1]) / 1e3, a[2][:40], b[2][:40])
                  for a, b in zip(kern, kern[1:]))[-3:][::-1]
    return busy / 1e3, (hi - lo) / 1e3, {n for _, _, n in kern}, gaps


def replay_report(prof, names):
    """What a graph driver's profile holds where it does not name the
    case's hand kernels: each name's activities (count, first starts and
    correlation ids) and the names the LM loop's window holds most."""
    import collections

    from torch.autograd import DeviceType

    events = prof.events()
    launches = [(e.time_range.start, e.id) for e in events
                if e.name == "cudaGraphLaunch"]
    print(f"      graph launches (host start, id): {launches}")
    for name in names:
        acts = sorted((e.time_range.start, e.id) for e in events
                      if e.device_type == DeviceType.CUDA and name in e.name)
        print(f"      {name}: {len(acts)} activities, first {acts[:3]}")
    window = busy_window(prof, True)
    seen = collections.Counter(n[:50] for n in window[2]) if window else {}
    print(f"      names in the window: {sorted(seen)[:40]}")


def private_pool_bytes():
    """Bytes of the caching allocator's segments held by private pools
    (CUDA graphs' and their loop bodies'), after emptying its cache."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def device_loop_case(label, solve, repeat_python=False, profiled=True):
    """One case of phase 14: ``solve(driver)`` with ``driver="while_loop"``
    and the Python driver (s per LM iteration: the graph's blocks'
    replays and reads, the Python driver's LM loop; peak device memory of
    each); then, unless ``profiled`` is False, each again under the
    profiler (device busy and idle share over the LM loop on the device's
    clock, :func:`busy_window`; for the graph from its first replay; with
    ``repeat_python`` the Python driver's profile is taken twice and both
    shares kept). The two
    drivers must give the same bits, iterations and PCG iterations, the
    graph at least one conditional node and the case's hand kernels among
    its kernel nodes (read from the graph), the profiler some device time
    in the replay, every idle share lie in [0, 1], and no private pool
    may outlive the case's graphs (each graph's and its loop bodies')."""
    t_case = time.time()
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeparc_tpu_torch.solver import device_loop

    pools0 = private_pool_bytes()
    loops = []
    device_loop.capture_hooks.append(loops.append)

    last = {}

    def profiled_run(driver):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve(driver)
            torch.cuda.synchronize()
        loops.clear()
        last[driver] = prof
        return busy_window(prof, driver == "while_loop")

    try:
        runs, peak = {}, {}
        # the graph first: its warm-up step leaves no first-call work in
        # the Python driver's loop
        for driver in ("while_loop", "python"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            res = solve(driver)
            torch.cuda.synchronize()
            runs[driver] = (res, time.time() - t0)
            peak[driver] = torch.cuda.max_memory_allocated() / 2**30
        # read the graph before its loop goes: each held loop holds its
        # graph's memory
        loop = loops.pop()
        nodes = loop.while_nodes()
        graph_kernels = loop.kernel_names()
        block_s = sum(loop.block_seconds)
        took = dict(warmup_s=loop.warmup_seconds,
                    capture_instantiate_s=loop.capture_seconds,
                    blocks=len(loop.block_seconds))
        del loop
        profiles = {driver: profiled_run(driver) for driver in
                    (("python", "while_loop") if profiled else ())}
        if repeat_python:
            profiles["python again"] = profiled_run("python")
    finally:
        device_loop.capture_hooks.remove(loops.append)
    py, wl = runs["python"][0], runs["while_loop"][0]
    # every graph of the case is gone: its pools, the bodies' too, must
    # have gone back to the caching allocator
    del runs
    kept_mib = (private_pool_bytes() - pools0) / 2**20
    same = (py.cost == wl.cost and py.iterations == wl.iterations
            and py.status == wl.status and all(
                torch.equal(getattr(py.params, f.name),
                            getattr(wl.params, f.name))
                for f in dataclasses.fields(py.params)))
    n = max(py.iterations, 1)
    rec = dict(
        iterations=py.iterations, status=py.status, cost=py.cost,
        same_bits=same,
        cg_iterations={"python": py.cg_iterations,
                       "while_loop": wl.cg_iterations},
        s_per_iteration={"python": py.seconds / n, "while_loop": block_s / n},
        peak_gib=peak, private_pools_kept_mib=kept_mib,
        conditional_nodes=nodes, **took)
    for driver, got in profiles.items():
        if got is None:
            raise AssertionError(f"{label}, {driver}: the profile holds no "
                                 f"LM loop (or no graph launch in it)")
        busy, window, _, gaps = got
        rec[driver] = dict(device_busy_ms=busy, window_ms=window,
                           idle_share=idle_share(busy, window),
                           largest_gaps=gaps)
    # the hand kernels of the case among the graph's kernel nodes (read
    # from the graph: the profiler may name a replay's kernels after those
    # of an earlier graph of the process, PERF.md section 7)
    missing = [h for h in REPLAY_KERNELS[label]
               if not any(h in n for n in graph_kernels)]
    rec["replay_kernels"] = {
        h: sum(h in n for n in graph_kernels) for h in REPLAY_KERNELS[label]}
    rec["profiler_names_hand_kernels"] = profiled and not [
        h for h in REPLAY_KERNELS[label]
        if not any(h in n for n in profiles["while_loop"][2])]
    print(f"  {label}: {py.iterations} iterations (status {py.status}), "
          f"cost {py.cost:.12e}, same bits as the Python driver: {same}; "
          f"s/iteration python {rec['s_per_iteration']['python']:.6f}, "
          f"while_loop {rec['s_per_iteration']['while_loop']:.6f} "
          f"({rec['blocks']} blocks, replay and read); warm-up "
          f"{took['warmup_s']:.3f} s, capture + instantiate "
          f"{took['capture_instantiate_s']:.3f} s; conditional nodes (top, "
          f"bodies) {nodes}; hand kernel nodes {rec['replay_kernels']} "
          f"(the profiler names them too: "
          f"{rec['profiler_names_hand_kernels']}); PCG "
          f"{rec['cg_iterations']}; peak memory "
          f"python {peak['python']:.2f} GiB, while_loop "
          f"{peak['while_loop']:.2f} GiB; private pools kept after the "
          f"case {kept_mib:.1f} MiB")
    for driver in ("python", "python again", "while_loop"):
        if driver not in rec:
            continue
        r = rec[driver]
        print(f"    {driver}, profiled LM loop: device busy "
              f"{r['device_busy_ms']:.3f} of {r['window_ms']:.3f} ms, idle "
              f"share {r['idle_share']:.4f}; largest gaps "
              f"{r['largest_gaps']}")
    if profiled and not rec["profiler_names_hand_kernels"]:
        replay_report(last["while_loop"], REPLAY_KERNELS[label])
    if not same:
        raise AssertionError(f"{label}: driver='while_loop' did not give "
                             f"the Python driver's bits")
    if py.cg_iterations != wl.cg_iterations:
        raise AssertionError(f"{label}: PCG iterations differ: "
                             f"{rec['cg_iterations']}")
    if not nodes or nodes[0] < 1:
        raise AssertionError(f"{label}: the graph holds no conditional node")
    if profiled and not rec["while_loop"]["device_busy_ms"]:
        raise AssertionError(f"{label}: the profiler saw no replay kernel")
    if missing:
        raise AssertionError(f"{label}: no kernel node of the graph is "
                             f"named {missing}")
    if kept_mib > 0:
        raise AssertionError(f"{label}: {kept_mib:.1f} MiB of private pools "
                             f"outlived the case's graphs")
    rec["case_seconds"] = time.time() - t_case
    print(f"    the case took {rec['case_seconds']:.1f} s")
    return rec


def fused_step_split(label, data):
    """Phase 14 (e): one classic and one fused-trial LM step (float64, the
    pipeline's full-BA free mask) on the route ``solve_ba_grid`` takes
    for the scene (banded when the band prep finds locality, else the
    monolithic kernels with the solve's plane stack). Each is timed on
    the host around the synchronised step (median of 3) and split by the
    profiler's device time (:func:`step_profile`) by kernel name
    (``STEP_PARTS``): the linearize, the cost pass, the select of the next
    system, the Schur solve's library products and factorisation, and the
    rest (the step's torch ops).
    Prints the bytes one fused iteration's select moves (it reads the
    trial system and the stored one and writes the stored one) and their
    time at 3.35 TB/s. The fused step writes its select into its state's
    system, so the timed runs leave that system at another iterate than
    the state's points (their time, not their values, is what is kept).
    Returns the record."""
    import dataclasses

    import torch

    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.scripts import HBM_BYTES_PER_S
    from deeparc_tpu_torch.solver.rig_band import band_grid
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        init_grid_state,
        init_grid_state_fused,
        make_grid_step,
        mono_stack,
    )

    scene = from_deeparc(data, dtype=torch.float64, device="cuda")
    grid, free = grid_from_scene(scene), freeze_masks(scene)
    params, pf = scene.params, free.points
    cam_free = flatten_camera(free)
    prep = band_grid(grid)
    if prep is not None:
        perm = prep.perm.long()
        grid = prep.grid
        params = dataclasses.replace(params, points=params.points[perm])
        pf = pf[perm]
        R = params.ext_rot.shape[0]
        bws, bbs = prep.widths
        kw = dict(band_widths=bws, band_blocks=bbs)
        fkw = dict(kw, band_intr_frozen=not bool(torch.any(
            cam_free[6 * R:] != 0)))
    else:
        kw = fkw = dict(pxm=mono_stack(grid, (256, 1024)))
    opts = SolverOptions()
    rec = {}
    for name in ("classic", "fused"):
        fused = name == "fused"
        step = make_grid_step(opts, params, fuse_trial=fused, **fkw)
        state = (init_grid_state_fused(params, grid, opts, cam_free, pf,
                                       **fkw) if fused
                 else init_grid_state(params, grid, opts, **kw))
        run = lambda: step(state, grid, cam_free, pf)
        wall = wall_ms(run, 3)
        times, busy, window = step_profile(run)
        split = dict(linearize=0.0, cost=0.0, select=0.0, schur=0.0,
                     rest=0.0)
        for kname, ms in times.items():
            part = next((p for p, keys in STEP_PARTS if any(
                key in kname for key in keys)), "rest")
            split[part] += ms
        rec[name] = dict(wall_ms=wall, device_ms=busy, window_ms=window,
                         idle_share=idle_share(busy, window), **split)
        if fused:
            sys_bytes = sum(t.numel() * t.element_size() for t in state.sys)
            rec["select_bytes"] = 3 * sys_bytes
            rec["select_bound_ms"] = 3 * sys_bytes / HBM_BYTES_PER_S * 1e3
            rec["E_shape"] = list(state.sys.E.shape)
        print(f"    one {name} step, {label}: wall {wall:.3f} ms (median of "
              f"3); device ms by part: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in split.items())
              + f"; device busy {busy:.3f} of {window:.3f} ms of the "
              f"profiled step, idle share {rec[name]['idle_share']:.4f}")
        del step, state, run
        torch.cuda.empty_cache()
    print(f"    the fused select moves {rec['select_bytes'] / 1e9:.3f} GB "
          f"(E {rec['E_shape']}: the trial and stored systems read, the "
          f"stored one written), {rec['select_bound_ms']:.3f} ms at 3.35 "
          f"TB/s")
    return rec


def nccl_capture_probe():
    """Phase 14 (f), first: does an NCCL ``all_reduce`` (the sharded steps'
    ``Reducer.sum``) capture inside a conditional WHILE node's body? Five
    passes of x <- (sum(2 x)) / 2 + 1 over the current group (one rank
    here: the communicator made by an eager call first), captured as one
    graph and replayed once; the body's node types (``CUgraphNodeType``:
    0 kernel, 1 memcpy, 2 memset, 13 conditional) and the result. Raises
    if the graph does not instantiate or gives another result."""
    import torch

    from deeparc_tpu_torch.kernels import graph_loop
    from deeparc_tpu_torch.parallel.multihost import Reducer, start_group

    start_group("cuda")
    red = Reducer()
    x = torch.arange(4, dtype=torch.float64, device="cuda")
    k = torch.zeros((), dtype=torch.int64, device="cuda")
    red.sum(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)

    def body():
        x.copy_(red.sum(x * 2.0) * 0.5 + 1.0)
        k.add_(1)

    with graph_loop.capture(k.device) as rec:
        try:
            with torch.cuda.graph(graph):
                graph_loop.while_loop(lambda: k < 5, body)
            kinds = [graph_loop.node_types(b) for b in rec.bodies]
            graph.instantiate()
            graph.replay()
            torch.cuda.synchronize()
        finally:
            rec.release()
    got = x.tolist()
    print(f"    NCCL all_reduce inside a WHILE body ({red.size} rank, "
          f"{red.backend}): captured and instantiated; body node types "
          f"{kinds}; after the replay k = {int(k)}, x = {got}")
    if int(k) != 5 or got != [5.0, 6.0, 7.0, 8.0]:
        raise AssertionError("the captured all_reduce loop gave another "
                             "result")
    return dict(body_node_types=kinds, k=int(k), x=got)


def sharded_result(res, template):
    """``solve_ba_sharded``'s result as a ``BAResult`` (points of every
    shard, the camera tables of ``template``'s layout)."""
    import dataclasses

    from deeparc_tpu_torch.residuals.reprojection import unflatten_camera
    from deeparc_tpu_torch.solver.ba import BAResult

    params = dataclasses.replace(unflatten_camera(res.cam_vec, template),
                                 points=res.points.reshape(-1, 3))
    return BAResult(params=params, cost=float(res.cost),
                    iterations=res.iterations, status=res.status,
                    seconds=res.seconds)


def phase_device_loop(args, flagship, uniform=None, tile_layout_=None):
    """Phase 14: ``driver="while_loop"`` on the card at full size, against
    ``driver="python"`` (:func:`device_loop_case`): ``solve_ba_grid`` on
    the banded occlusion flagship and on the monolithic uniform-random
    rig, each with the classic step and then (e) with the fused-trial step
    (``fuse_trial=True``, not profiled: the same iterations and the
    classic final cost within ``FUSED_COST_RTOL``, and one step of each
    split, :func:`fused_step_split`); ``solve_tiles_prepared`` on the windowed
    BAL scene (ITERATIVE_SCHUR, 30 PCG at the pipeline's tolerance);
    ``solve_ba`` (DENSE_SCHUR, 3 iterations) on the flagship, its Python
    driver profiled twice; then (f) the sharded solves at one NCCL rank
    (in a one-rank group that :func:`nccl_capture_probe` starts, first
    checking that an ``all_reduce`` captures inside a WHILE body;
    destroyed after):
    ``solve_ba_grid_sharded`` on the flagship, ``solve_ba_sharded`` on the
    flagship (DENSE_SCHUR, one block) and ``solve_ba_tiles_sharded`` on
    phase 13d's scene (``locality=False``, 30 PCG). Returns the
    records."""
    import torch
    import torch.distributed as dist

    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.io import make_bal_windowed_host
    from deeparc_tpu_torch.parallel.sharded_ba import (
        shard_scene,
        solve_ba_sharded,
    )
    from deeparc_tpu_torch.parallel.sharded_grid import solve_ba_grid_sharded
    from deeparc_tpu_torch.parallel.sharded_tiles import (
        solve_ba_tiles_sharded,
    )
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.ba import solve_ba
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        solve_ba_grid,
    )
    from deeparc_tpu_torch.solver.tiles import (
        solve_tiles_prepared,
        tiles_from_scene,
    )

    print("[phase 14] the on-device LM driver (driver='while_loop': one "
          "CUDA graph a solve, WHILE nodes for the LM block and PCG), "
          "float64")
    t_phase = time.time()
    uniform = uniform or flagship_rig(args.n_points, None, 1)
    rec = {}
    # no convergence test ends these solves early: each runs its iterations
    run_on = dict(function_tolerance=0.0, parameter_tolerance=0.0,
                  gradient_tolerance=0.0, progress_to_stdout=False)
    iters, block = DEVICE_LOOP_ITERATIONS["grid"]
    opts = SolverOptions(max_iterations=iters, **run_on)
    for label, data in (("banded flagship", flagship),
                        ("monolithic uniform rig", uniform)):
        scene = from_deeparc(data, dtype=torch.float64, device="cuda")
        grid, free = grid_from_scene(scene), freeze_masks(scene)
        reuse: dict = {}
        for fused in (False, True):
            name = f"{label}, fused" if fused else label
            # the fused solves' steps are split below, not profiled here
            rec[name] = device_loop_case(name, lambda driver: solve_ba_grid(
                scene.params, grid, free, opts, driver=driver,
                while_block=block, band_reuse=reuse, fuse_trial=fused),
                profiled=not fused)
            if (reuse["prep"] is None) != (label != "banded flagship"):
                raise AssertionError(f"{label}: the band prep took the "
                                     f"other route")
        classic, fused = rec[label], rec[f"{label}, fused"]
        rel = abs(fused["cost"] - classic["cost"]) / abs(classic["cost"])
        fused["rel_cost_to_classic"] = rel
        print(f"  {label}: fused-trial against classic: {fused['iterations']}"
              f" and {classic['iterations']} iterations, relative cost "
              f"difference {rel:.3e} (tol {FUSED_COST_RTOL:g})")
        if (fused["iterations"] != classic["iterations"]
                or not rel <= FUSED_COST_RTOL):
            raise AssertionError(f"{label}: the fused-trial solve strays "
                                 f"from the classic one")
        del scene, grid, free, reuse
        torch.cuda.empty_cache()
        fused["step_split"] = fused_step_split(label, data)
        torch.cuda.empty_cache()
    if tile_layout_ is None:
        tile_layout_ = tile_layout(make_bal_windowed_host(
            n_points=args.tile_points, seed=0, **TILE_SCENE), True)
    tiles, params_t, free_t, _, cam_free = tile_layout_
    iters, block = DEVICE_LOOP_ITERATIONS["tiles"]
    topts = SolverOptions(max_iterations=iters, **run_on,
                          linear_solver="iterative_schur",
                          cg_max_iterations=30)
    rec["windowed BAL scene"] = device_loop_case(
        "windowed BAL scene", lambda driver: solve_tiles_prepared(
            params_t, tiles, free_t, cam_free, topts, driver=driver,
            while_block=block))
    del tiles, params_t, free_t, cam_free, tile_layout_
    torch.cuda.empty_cache()
    iters, block = DEVICE_LOOP_ITERATIONS["indexed"]
    scene = from_deeparc(flagship, dtype=torch.float64, device="cuda")
    free = freeze_masks(scene)
    iopts = SolverOptions(max_iterations=iters, **run_on,
                          linear_solver="dense_schur")
    rec["indexed flagship"] = device_loop_case(
        "indexed flagship", lambda driver: solve_ba(
            scene.params, scene.index, free, iopts, driver=driver),
        repeat_python=True)
    torch.cuda.empty_cache()

    print("  (f) the sharded solves at one NCCL rank, both drivers (on the "
          "card each rank's block is one CUDA graph with the all_reduce "
          "calls in its WHILE bodies)")
    rec["nccl_capture_probe"] = nccl_capture_probe()
    grid = grid_from_scene(scene)
    iters, block = DEVICE_LOOP_ITERATIONS["grid"]
    rec["grid-sharded"] = device_loop_case(
        "grid-sharded", lambda driver: solve_ba_grid_sharded(
            scene.params, grid, free, opts, driver=driver,
            while_block=block))
    print(f"    process group: {dist.get_world_size()} rank, "
          f"{dist.get_backend()}")
    del grid
    torch.cuda.empty_cache()
    sharded = shard_scene(scene, free, 1)
    rec["sharded indexed"] = device_loop_case(
        "sharded indexed", lambda driver: sharded_result(solve_ba_sharded(
            sharded, iopts, device="cuda", driver=driver), scene.params))
    del scene, free, sharded
    torch.cuda.empty_cache()
    tscene = from_deeparc(make_bal_windowed_host(
        n_points=args.global_points, seed=1, **TILE_SCENE),
        dtype=torch.float64, device="cuda")
    tfree = freeze_masks(tscene)
    tiles, params_t, free_t = tiles_from_scene(tscene, tfree, locality=False)
    iters, block = DEVICE_LOOP_ITERATIONS["sharded tiles"]
    sopts = SolverOptions(max_iterations=iters, **run_on,
                          linear_solver="iterative_schur",
                          cg_max_iterations=30)
    rec["tiles-sharded"] = device_loop_case(
        "tiles-sharded", lambda driver: solve_ba_tiles_sharded(
            params_t, tiles, free_t, flatten_camera(tfree), sopts,
            driver=driver, while_block=block))
    del tscene, tfree, tiles, params_t, free_t
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"  phase 14 took {time.time() - t_phase:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# The device-side scene generators, the NaN toggle and the trace (phase 15)
# ---------------------------------------------------------------------------

# LM iterations of each phase 15 solve (the Python driver), at most
# GEN_MAX_ITERATIONS where the RMSE needs them
GEN_ITERATIONS = 10
GEN_MAX_ITERATIONS = 20


def layout_bytes(layout) -> int:
    """Device bytes of a layout's tensors (planes, tables, bins, maps)."""
    from deeparc_tpu_torch.solver.device_loop import tree_leaves

    seen, total = set(), 0
    for t in tree_leaves(layout):
        key = (t.data_ptr(), t.numel())
        if key not in seen:
            seen.add(key)
            total += nbytes(t)
    return total


def generated(label, gen):
    """``gen()`` twice, timed (synchronised): the two results must hold
    the same bits. Returns (the first result, its seconds)."""
    import torch

    from deeparc_tpu_torch.solver.device_loop import tree_leaves

    times = []
    outs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        outs.append(gen())
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        if len(outs) == 2:
            a, b = tree_leaves(outs[0]), tree_leaves(outs[1])
            if len(a) != len(b) or not all(
                    x.shape == y.shape and torch.equal(x, y)
                    for x, y in zip(a, b)):
                raise AssertionError(f"{label}: two calls with one seed gave "
                                     f"different bits")
            del outs[1], a, b
    print(f"  {label}: generated in {times[0]:.3f} s (again {times[1]:.3f} "
          f"s, the same bits)")
    return outs[0], times[0]


def solve_generated(label, solve, cost0, n_obs):
    """``solve(max_iterations)`` with the Python driver: the cost must fall
    and the RMSE (sqrt(2 cost / observations)) sit under twice the pixel
    noise; GEN_ITERATIONS iterations, again up to GEN_MAX_ITERATIONS when
    the RMSE needs them. Returns its record."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = solve(GEN_ITERATIONS)
    rmse = (2.0 * res.cost / n_obs) ** 0.5
    more = not rmse < 2 * PIXEL_NOISE
    if more:
        res = solve(GEN_MAX_ITERATIONS)
        rmse = (2.0 * res.cost / n_obs) ** 0.5
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_iter = res.seconds / max(res.iterations, 1)
    print(f"  {label}: cost {cost0:.6e} -> {res.cost:.6e} in "
          f"{res.iterations} LM iterations"
          + (f" ({res.cg_iterations} CG)" if res.cg_iterations else "")
          + f", {per_iter:.6f} s/iteration (Python driver, at most "
          f"{GEN_MAX_ITERATIONS if more else GEN_ITERATIONS} iterations"
          + (": the RMSE needed more than " + str(GEN_ITERATIONS)
             if more else "") + f"), RMSE {rmse:.6f} px, peak memory "
          f"{peak:.2f} GiB")
    if not res.cost < cost0:
        raise AssertionError(f"{label}: the solve did not lower the cost")
    if not rmse < 2 * PIXEL_NOISE:
        raise AssertionError(f"{label}: RMSE {rmse} px not under "
                             f"{2 * PIXEL_NOISE} px")
    return dict(cost0=cost0, cost=res.cost, iterations=res.iterations,
                cg_iterations=res.cg_iterations, s_per_iteration=per_iter,
                rmse_px=rmse, solve_peak_gib=peak,
                iterations_cap=GEN_MAX_ITERATIONS if more
                else GEN_ITERATIONS)


def gen_grid(args, rec, host):
    """15a: the occlusion rig of bench.py in the grid layout, band-prepped
    and solved with the banded kernels; ``host`` is phase 3's seconds for
    the host flagship and its grid (None when phase 3 did not run).
    Returns (params, grid, free)."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.io import make_grid_rig_device
    from deeparc_tpu_torch.solver.rig_band import band_grid
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_cost,
        init_grid_state,
        slot_params,
        solve_ba_grid,
    )

    n = args.n_points
    print(f"[phase 15a] make_grid_rig_device(8, 24, {n}, visibility=10/48, "
          f"occlusion_rings=6), band_grid, solve_ba_grid")
    torch.cuda.reset_peak_memory_stats()
    (params, grid, gt), gen_s = generated("15a grid rig", lambda:
        make_grid_rig_device(
            n_arc=8, n_ring=24, n_points=n, visibility=10 / 48,
            occlusion_rings=6, pixel_noise=PIXEL_NOISE, point_noise=0.02,
            seed=0, dtype=torch.float64))
    gen_peak = torch.cuda.max_memory_allocated() / 2**30
    del gt
    live = int(grid.mask.sum())
    torch.cuda.synchronize()
    t0 = time.time()
    prep = band_grid(grid)
    torch.cuda.synchronize()
    band_s = time.time() - t0
    if prep is None:
        raise AssertionError("15a: band_grid declined the generated rig")
    free = grid_free(params)
    cost0 = float(init_grid_state(params, grid, SolverOptions()).cost)
    k.reset_launch_counts()
    opts = dict(progress_to_stdout=False)
    r = solve_generated("15a solve", lambda it: solve_ba_grid(
        params, grid, free, SolverOptions(max_iterations=it, **opts),
        band_reuse={"prep": prep}), cost0, live)
    launches = {fn.__name__: fn.launches
                for fn in (k.linearize_grid_banded, k.cost_grid_banded)}
    host_txt = ("host flagship (make_hemisphere_rig + grid_from_scene) "
                + (f"{host:.3f} s" if host is not None else
                   "not measured in this run"))
    print(f"  15a: {n} points, {live} live observations, layout "
          f"{layout_bytes(grid) / 1e9:.3f} GB, generation peak "
          f"{gen_peak:.2f} GiB; band_grid {band_s:.3f} s (widths "
          f"{prep.widths}); {host_txt}; launches {launches}")
    for name, n_l in launches.items():
        if n_l <= 0:
            raise AssertionError(f"15a: {name} did not launch")
    rec["grid"] = dict(points=n, live_observations=live,
                       layout_bytes=layout_bytes(grid), generate_s=gen_s,
                       host_scene_s=host, band_grid_s=band_s,
                       generate_peak_gib=gen_peak, launches=launches, **r)
    return params, grid, free


def count_calls(module, names):
    """Wrap ``module``'s functions ``names`` to count their calls (the tile
    step's torch paths); returns (counts, restore)."""
    counts = {n: 0 for n in names}
    saved = {n: getattr(module, n) for n in names}

    def wrap(n):
        def counted(*a, **kw):
            counts[n] += 1
            return saved[n](*a, **kw)
        return counted

    for n in names:
        setattr(module, n, wrap(n))

    def restore():
        for n, fn in saved.items():
            setattr(module, n, fn)
    return counts, restore


def hold_buckets(label, params, tiles, cam_free):
    """Each bucket of a generated layout that a kernel takes, held against
    the plain versions on the same inputs at the float64 tolerance:
    ``tile_linearize_local`` (on the buckets :func:`bucket_fused_ok`
    passes), then the bucket's sweep kernel (``tile_sweep_local`` with
    local tables, else ``tile_sweep``) in its three modes on the planes
    the solver would sweep (the kernel's, or the torch chunk path's on a
    wider bucket) and a random cell vector. Returns {width: {kernel:
    worst relative error}}; raises over tolerance."""
    import torch

    from deeparc_tpu_torch.kernels import tile as k
    from deeparc_tpu_torch.solver import tiles as tmod
    from deeparc_tpu_torch.solver.linalg import inv3x3
    from deeparc_tpu_torch.solver.rig_grid import slot_params

    dtype = params.points.dtype
    packed = tmod.pack_cells(slot_params(params, tiles.cells), tiles.cells,
                             cam_free)
    V = packed.shape[0]
    rng = torch.Generator(device="cuda").manual_seed(0)
    lin_labels = ("cost", "pout", "r_t", "jx_t", "jcam_t", "gc", "hc")
    out: dict = {}
    off = 0
    for b in tiles.buckets:
        Nb, W = b.cell.shape
        pts_b = params.points[off:off + Nb]
        off += Nb
        if not b.bins:
            continue            # the torch paths only
        errs = out.setdefault(W, {})
        pf_b = torch.ones_like(pts_b)
        print(f"  {label}: bucket W = {W}, {Nb} rows, "
              + (f"{b.loc[1].shape[1]}-cell local tables" if b.loc else
                 "global cell ids"))
        rows = None
        if tmod.bucket_fused_ok(b):
            la = lin_args(b, pts_b, pf_b, packed, dtype, True)
            got = k.tile_linearize_local(*la, bins=b.bins)
            errs["tile_linearize_local"] = compare(
                "tile_linearize_local", "float64", got,
                k.tile_linearize_local_plain(*la), lin_labels)[0]
            _, pout, _, jx_t, jcam_t, _, _ = got
            gp_t = pout[0:3].contiguous()
            hpp = pout[3:12].T.reshape(Nb, 3, 3)
            cell_t = b.loc[0].T.contiguous()
            del got, la
        else:
            _, blk, gp_b, hpp, _, _ = tmod._linearize_bucket_torch(
                pts_b, pf_b, b, packed, "trivial", 0.5)
            cell_t, jcam_t, jx_t = k.pack_bucket_planes(
                blk.j_x, blk.j_cam, b.loc[0] if b.loc else b.cell)
            gp_t = gp_b.T.contiguous()
            rows = blk.j_cam
        binv_t = inv3x3(hpp + 0.1 * torch.eye(3, dtype=dtype, device="cuda"))
        binv_t = binv_t.reshape(Nb, 9).T.contiguous()
        v_cells = torch.randn((V, 18), dtype=dtype, device="cuda",
                              generator=rng)
        if b.loc:
            cc = b.loc[1].long()
            v_arg = v_cells[cc].transpose(1, 2).contiguous()
            name, kern, plain = ("tile_sweep_local", k.tile_sweep_local,
                                 k.tile_sweep_local_plain)
            srt = k.sort_jcam_planes(jcam_t, b.bins, cc.shape[0])
        else:
            v_arg = v_cells
            name, kern, plain = "tile_sweep", k.tile_sweep, k.tile_sweep_plain
            srt = k.sort_jcam(rows, b.bins, jcam_t.dtype)
        sw = (cell_t, jcam_t, jx_t, binv_t, gp_t, v_arg)
        errs[name] = max(
            compare(name, "float64",
                    kern(*sw, mode=mode, bins=b.bins, sorted_jcam=srt),
                    plain(*sw, mode=mode), (mode,))[0]
            for mode in ("rhs", "matvec", "edot"))
        del sw, srt, rows, jcam_t, jx_t
        torch.cuda.empty_cache()
    return out


def gen_tiles(label, tag, make, rec, kernels, torch_paths=False):
    """15b-d: a generated tile layout solved by ``solve_tiles_prepared``
    (ITERATIVE_SCHUR, 30 PCG); the wrappers ``kernels`` must launch, and
    after the solve each bucket they take is held against the plain
    versions (:func:`hold_buckets`). With ``torch_paths`` the tile step's
    torch paths (the chunk-path linearize of the wide or table-less
    buckets, the torch sweeps of the wide ones) are counted and must
    run."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.solver import tiles as tmod

    torch.cuda.reset_peak_memory_stats()
    (params, tiles, gt, cam_free), gen_s = generated(label, make)
    gen_peak = torch.cuda.max_memory_allocated() / 2**30
    n_rows = gt.shape[0]
    del gt
    live = int(sum(float(b.mask.sum()) for b in tiles.buckets))
    widths = [b.cell.shape[1] for b in tiles.buckets]
    rows = [b.cell.shape[0] for b in tiles.buckets]
    routes = [("kernel" if tmod.bucket_fused_ok(b) else "torch")
              + "/" + ("kernel" if b.bins else "torch")
              for b in tiles.buckets]
    print(f"  {label}: widths {widths}, rows {rows}, local tables "
          f"{[b.loc[1].shape[1] if b.loc else None for b in tiles.buckets]}, "
          f"linearize/sweep routes {routes}, {live} live observations, "
          f"layout {layout_bytes(tiles) / 1e9:.3f} GB, generation peak "
          f"{gen_peak:.2f} GiB")
    pf = torch.ones_like(params.points)
    opts = dict(linear_solver="iterative_schur", cg_max_iterations=30,
                progress_to_stdout=False)
    cost0 = float(tmod.init_tile_state(params, tiles, SolverOptions(**opts),
                                       cam_free).cost)
    k.reset_launch_counts()
    counts = restore = None
    if torch_paths:
        counts, restore = count_calls(
            tmod, ("_linearize_bucket_torch", "_e_sweep", "_e_dot_cells"))
    try:
        r = solve_generated(f"{label} solve", lambda it:
                            tmod.solve_tiles_prepared(
                                params, tiles, pf, cam_free,
                                SolverOptions(max_iterations=it, **opts)),
                            cost0, live)
    finally:
        if restore is not None:
            restore()
    launches = {fn.__name__: fn.launches for fn in kernels}
    print(f"  {label}: launches {launches}"
          + (f"; torch paths' calls {counts}" if counts else ""))
    for name, n_l in launches.items():
        if n_l <= 0:
            raise AssertionError(f"{label}: {name} did not launch")
    if torch_paths:
        wide_lin = sum(not tmod.bucket_fused_ok(b) for b in tiles.buckets)
        wide_sweep = sum(not b.bins for b in tiles.buckets)
        if wide_lin and counts["_linearize_bucket_torch"] < wide_lin:
            raise AssertionError(f"{label}: the torch linearize did not run "
                                 f"on the {wide_lin} wide buckets")
        if wide_sweep and not (counts["_e_sweep"]
                               and counts["_e_dot_cells"]):
            raise AssertionError(f"{label}: the torch sweeps did not run on "
                                 f"the {wide_sweep} widest buckets")
    held = hold_buckets(label, params, tiles, cam_free)
    rec[tag] = dict(points=n_rows, live_observations=live, widths=widths,
                    rows=rows, routes=routes,
                    layout_bytes=layout_bytes(tiles), generate_s=gen_s,
                    generate_peak_gib=gen_peak, launches=launches,
                    torch_path_calls=counts, max_rel_err_vs_plain=held, **r)
    return rec[tag]


def nan_and_trace(args, params, grid, free, rec):
    """15e: the banded solve of 15a's scene with the NaN toggle on and off
    (the same bits; s/iteration of each), a point moved onto camera (0,
    0)'s z = 0 plane in a small generated rig (on: FloatingPointError
    naming an operator; off: NaNs, silently), the same on a small tile rig
    solved with driver="while_loop", and ``trace_to`` around two
    LM iterations of the monolithic grid solve, whose trace must name
    linearize_grid's kernel."""
    import dataclasses
    import os
    import shutil

    import torch

    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.io import make_grid_rig_device, make_tile_rig_device
    from deeparc_tpu_torch.solver.rig_grid import solve_ba_grid
    from deeparc_tpu_torch.solver.tiles import solve_tiles_prepared
    from deeparc_tpu_torch.utils import debug, trace_to

    print("[phase 15e] --debug-nans and trace_to on the card")
    run_on = dict(function_tolerance=0.0, parameter_tolerance=0.0,
                  gradient_tolerance=0.0, progress_to_stdout=False)
    out = {}
    res = {}
    for on in (False, True):
        checks0 = debug.checks
        with debug.nan_debugging(on):
            r = solve_ba_grid(params, grid, free, SolverOptions(
                max_iterations=GEN_ITERATIONS, **run_on))
        res[on] = r
        out[f"s_per_iteration_{'on' if on else 'off'}"] = \
            r.seconds / max(r.iterations, 1)
        out[f"checks_{'on' if on else 'off'}"] = debug.checks - checks0
    same = (res[True].cost == res[False].cost and all(
        torch.equal(getattr(res[True].params, f.name),
                    getattr(res[False].params, f.name))
        for f in dataclasses.fields(res[True].params)))
    print(f"  banded solve of 15a's rig, {GEN_ITERATIONS} iterations: "
          f"toggle off {out['s_per_iteration_off']:.6f} s/iteration "
          f"({out['checks_off']} checks), on "
          f"{out['s_per_iteration_on']:.6f} s/iteration "
          f"({out['checks_on']} checks); the same bits: {same}")
    if not same or out["checks_off"] != 0 or out["checks_on"] <= 0:
        raise AssertionError("15e: the NaN toggle changed the solve's bits, "
                             "or checked with the toggle off")

    p, g, _ = make_grid_rig_device(n_arc=8, n_ring=24, n_points=2000,
                                   visibility=10 / 48, occlusion_rings=6,
                                   pixel_noise=PIXEL_NOISE, seed=3,
                                   dtype=torch.float64)
    seen = torch.nonzero(g.mask[:, 0] > 0.5)
    if seen.numel() == 0:
        raise AssertionError("15e: no point of the small rig is seen from "
                             "camera (0, 0)")
    pts = p.points.clone()
    i = int(seen[0, 0])
    pts[i, 2] = 0.0    # camera (0, 0)'s frame is the world frame
    bad = dataclasses.replace(p, points=pts)
    opts = SolverOptions(max_iterations=2, progress_to_stdout=False)
    silent = solve_ba_grid(bad, g, grid_free(bad), opts)
    if silent.cost == silent.cost:
        raise AssertionError("15e: the toggle off: the degenerate point "
                             "gave no NaN")
    try:
        with debug.nan_debugging(True):
            solve_ba_grid(bad, g, grid_free(bad), opts)
    except FloatingPointError as e:
        message = str(e)
    else:
        raise AssertionError("15e: the toggle on did not raise")
    if "produced by" not in message:
        raise AssertionError(f"15e: the error names no operator: {message}")
    print(f"  point {i} on camera (0, 0)'s z = 0 plane: off, cost "
          f"{silent.cost} (silent); on, FloatingPointError: {message}")
    out["nan_message"] = message

    # the same on the tile engine under driver="while_loop": the block's
    # state is read back with a NaN, and its steps (whose ITERATIVE_SCHUR
    # PCG is a device loop) re-run eagerly to name the operator
    p, t, _, cf = make_tile_rig_device(3, 6, 2000, track_length=5,
                                       pixel_noise=PIXEL_NOISE, seed=3,
                                       dtype=torch.float64)
    b = t.buckets[0]
    # cell 0 is outer record 0 and the identity inner row: its camera's
    # frame is the world frame
    seen = torch.nonzero(((b.cell == 0) & (b.mask > 0.5)).any(1))
    if seen.numel() == 0:
        raise AssertionError("15e: no point of the small tile rig is seen "
                             "in cell 0")
    i = int(seen[0, 0])
    pts = p.points.clone()
    pts[i, 2] = 0.0
    bad = dataclasses.replace(p, points=pts)
    topts = SolverOptions(max_iterations=2, linear_solver="iterative_schur",
                          cg_max_iterations=10, progress_to_stdout=False)
    solve = lambda: solve_tiles_prepared(bad, t, torch.ones_like(pts), cf,
                                         topts, driver="while_loop")
    silent = solve()
    if silent.cost == silent.cost:
        raise AssertionError("15e: the toggle off: the degenerate point "
                             "gave the tile solve no NaN")
    try:
        with debug.nan_debugging(True):
            solve()
    except FloatingPointError as e:
        message = str(e)
    else:
        raise AssertionError("15e: the toggle on did not raise in the tile "
                             "while_loop solve")
    if "produced by" not in message or "while_loop" not in message:
        raise AssertionError(f"15e: the tile while_loop error names no "
                             f"operator: {message}")
    print(f"  tile rig, driver='while_loop', ITERATIVE_SCHUR: point {i} on "
          f"cell 0's z = 0 plane: off, cost {silent.cost} (silent); on, "
          f"FloatingPointError: {message}")
    out["nan_message_tiles_while_loop"] = message

    p, g, _ = make_grid_rig_device(n_arc=8, n_ring=24, n_points=args.n_points,
                                   visibility=10 / 192,
                                   pixel_noise=PIXEL_NOISE, seed=1,
                                   dtype=torch.float64)
    route, _ = mono_route(g, torch.float64)
    kname = route.split()[0]
    logdir = os.path.join("build", "chip_smoke_trace")
    shutil.rmtree(logdir, ignore_errors=True)
    opts = SolverOptions(max_iterations=2, progress_to_stdout=False,
                         **{k_: v for k_, v in run_on.items()
                            if k_ != "progress_to_stdout"})
    with trace_to(logdir) as prof:
        r = solve_ba_grid(p, g, grid_free(p), opts)
        torch.cuda.synchronize()
    with open(prof.trace_path) as f:
        trace = f.read()
    size = os.path.getsize(prof.trace_path)
    shutil.rmtree(logdir, ignore_errors=True)
    print(f"  trace_to around {r.iterations} LM iterations of the monolithic "
          f"grid solve ({args.n_points} points, visibility 10/192): "
          f"{size / 1e6:.1f} MB Chrome trace; holds {kname}: "
          f"{kname in trace}")
    if kname not in trace:
        raise AssertionError(f"15e: the trace does not name {kname}")
    out.update(trace_bytes=size, trace_kernel=kname)
    rec["nan_and_trace"] = out


def phase_generated(args, host_s):
    """Phase 15: bench.py's four generated scenes built on the card by the
    device-side generators (each twice for the same bits) and solved with
    the Python driver (15a-d), then the NaN toggle and the trace (15e).
    ``host_s`` holds the seconds the same run spent on the host scenes of
    these sizes: ``flagship`` (phase 3) and ``bal`` (phase 6), where those
    phases ran. Returns the records."""
    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.io import (
        make_bal_heavytail_device,
        make_bal_tile_device,
        make_tile_rig_device,
    )

    print("[phase 15] the device-side scene generators at bench.py's sizes, "
          "float64")
    t_phase = time.time()
    rec: dict = {}
    params, grid, free = gen_grid(args, rec, host_s.get("flagship"))
    nan_and_trace(args, params, grid, free, rec)
    del params, grid, free
    torch.cuda.empty_cache()

    f64 = dict(pixel_noise=PIXEL_NOISE, point_noise=0.02, seed=0,
               dtype=torch.float64)
    print(f"[phase 15b] make_tile_rig_device(8, 24, {args.n_points}, "
          f"track_length=10), solve_tiles_prepared")
    gen_tiles("15b tile rig", "tile_rig", lambda: make_tile_rig_device(
        8, 24, args.n_points, track_length=10, **f64), rec,
        (k.tile_linearize_local, k.tile_sweep_local))
    torch.cuda.empty_cache()

    host = host_s.get("bal")
    host_txt = (f"{host:.3f} s" if host is not None
                else "not measured in this run")
    print(f"[phase 15c] make_bal_tile_device(2000, {args.tile_points}, "
          f"track_length=8, window=None), solve_tiles_prepared; the host's "
          f"windowed BAL scene + tiles_from_scene of phase 6: {host_txt}")
    r = gen_tiles("15c BAL, uniform tracks", "bal_uniform",
                  lambda: make_bal_tile_device(
                      n_cameras=2000, n_points=args.tile_points,
                      track_length=8, window=None, **f64), rec,
                  (k.tile_sweep,))
    r["host_scene_s"] = host
    torch.cuda.empty_cache()

    print(f"[phase 15d] make_bal_heavytail_device(2000, {args.tile_points}, "
          f"mean_track=8.0, window=128), solve_tiles_prepared; the host's "
          f"scene of phase 6: {host_txt}")
    r = gen_tiles("15d BAL, heavy-tailed tracks", "bal_heavytail",
                  lambda: make_bal_heavytail_device(
                      n_cameras=2000, n_points=args.tile_points,
                      mean_track=8.0, window=128, **f64), rec,
                  (k.tile_linearize_local, k.tile_sweep_local),
                  torch_paths=True)
    r["host_scene_s"] = host
    if max(r["widths"]) < 128 or min(r["widths"]) != 4:
        raise AssertionError(f"15d: widths {r['widths']} do not span W = 4 "
                             f"to at least 128")
    torch.cuda.empty_cache()
    rec["phase_seconds"] = time.time() - t_phase
    print(f"  phase 15 took {rec['phase_seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# The remaining impl paths (phase 16)
# ---------------------------------------------------------------------------

# the tile impls' steps from one state: the same algebra, summed in other
# orders, so their costs and iterates within this relative difference
IMPL_RTOL = 1e-9
# LM iterations of 16b's xla tile solve and its block; of 16b's and 16c's
# grid solves
XLA_ITERATIONS = (2, 2)
GRID_IMPL_ITERATIONS = 3
# 16c's torch-path and band="none" solves against the kernel path's: the
# same iterates, costs within this relative difference (planes takes the
# fused step, whose cost is the linearize's)
GRID_IMPL_COST_RTOL = 1e-9
# the hand kernels the torch paths' graphs must hold: the tile engine's
# fixed-order sums (sum_rows); the grid's plain versions launch none
REPLAY_KERNELS["xla, windowed BAL scene"] = ("gather_cells", "set_condition")
REPLAY_KERNELS["planes, occlusion flagship"] = ("schur_tiles",
                                               "set_condition")


def rel_diff(a, b) -> float:
    """max |a - b| / max |b| (0 where both are 0)."""
    import torch

    a, b = torch.as_tensor(a), torch.as_tensor(b)
    scale = float(torch.max(torch.abs(b)))
    return float(torch.max(torch.abs(a - b))) / scale if scale else 0.0


def impl_step_split(impl, layout, opts):
    """Phase 16a, one impl: one 30-PCG tile step (float64) from the
    layout's start state: host wall time around the synchronised step
    (median of 3), peak memory of one step, the idle share over one
    profiled step (:func:`step_profile`), and each part timed alone with
    CUDA events: the linearize (the xla path bins in it), the kernel
    path's sweep set-up (its planes and sorted copy), the rhs sweep, one
    matvec sweep, edot and the trial cost. Returns (the next state, info,
    record, the step's runner)."""
    import torch

    from deeparc_tpu_torch.solver.linalg import inv3x3
    from deeparc_tpu_torch.solver.tiles import (
        _e_dot_cells,
        _e_sweep,
        _make_kernel_sweeps,
        init_tile_state,
        linearize_tiles,
        linearize_tiles_mixed,
        make_tile_step,
        tile_cost,
    )

    tiles, params_t, free_t, packed, cam_free = layout
    C, V = cam_free.numel(), tiles.cells.cols.shape[0]
    step = make_tile_step(opts, params_t, impl=impl)
    state = init_tile_state(params_t, tiles, opts, cam_free)
    run = lambda: step(state, tiles, cam_free, free_t)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    nxt, info = run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = wall_ms(run, 3)
    _, busy, window = step_profile(run)

    kernels = impl == "pallas"
    if kernels:
        lin = lambda: linearize_tiles_mixed(state.points, packed, tiles,
                                            free_t, C)
    else:
        lin = lambda: linearize_tiles(state.points, packed, tiles, free_t, C)
    parts = {"linearize": time_ms(lin, 3)}
    sys_, planes = lin() if kernels else (lin(), None)
    binv = inv3x3(sys_.hpp + torch.eye(3, dtype=sys_.hpp.dtype,
                                       device="cuda"))
    if kernels:
        setup = lambda: _make_kernel_sweeps(tiles, sys_, binv, planes, None,
                                            256)
        parts["sweep set-up"] = time_ms(setup, 3)
        sweep, edot = setup()
    else:
        sweep = lambda v, rhs: _e_sweep(tiles, sys_, binv, v, rhs)
        edot = lambda v: _e_dot_cells(tiles, sys_, v)
    v = torch.randn((V, 18), dtype=torch.float64, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    parts["rhs sweep"] = time_ms(lambda: sweep(None, True), 3)
    parts["matvec sweep"] = time_ms(lambda: sweep(v, False), 3)
    # the matvec sweep's device time by kernel, its five largest
    top = sorted(device_ms(lambda: sweep(v, False)).items(),
                 key=lambda kv: -kv[1])[:5]
    parts["edot"] = time_ms(lambda: edot(v), 3)
    parts["trial cost"] = time_ms(lambda: tile_cost(state.points, packed,
                                                    tiles), 3)
    rec = dict(wall_ms=wall, parts_ms=parts, device_busy_ms=busy,
               window_ms=window, idle_share=idle_share(busy, window),
               peak_gib=peak, cg_iterations=int(info.cg_iters),
               accepted=bool(info.accepted), matvec_kernels_ms=dict(top))
    print(f"  {impl}: one LM step (f64, {info.cg_iters} PCG iterations, "
          f"accepted {bool(info.accepted)}): wall {wall:.3f} ms (median of "
          f"3); device ms by part (each alone): "
          + ", ".join(f"{k} {x:.3f}" for k, x in parts.items())
          + f"; device busy {busy:.3f} of {window:.3f} ms of the profiled "
          f"step, idle share {rec['idle_share']:.4f}; peak memory "
          f"{peak:.2f} GiB")
    print(f"    its matvec sweep's largest kernels (device ms): "
          + "; ".join(f"{n[:60]} {x:.3f}" for n, x in top))
    del sys_, planes, binv
    return nxt, info, rec, run


def phase_impls(args, flagship, tile_layout_=None):
    """Phase 16: the impl paths that no hand kernel of their own carries,
    float64 on the card. (a) one 30-PCG tile step on phase 6's windowed
    BAL layout under ``pallas`` (the kernel path) and ``xla`` (the torch
    chunk linearize and sweeps), each split by :func:`impl_step_split`;
    the two next states within ``IMPL_RTOL`` of each other in cost,
    points and camera vector, with the same accept decision, and the xla
    step run twice bit for bit. (b) the torch paths under both drivers
    (:func:`device_loop_case`, not profiled): ``solve_tiles_prepared(
    impl="xla")`` on that layout and ``solve_ba_grid(impl="planes")`` on
    the occlusion flagship, the same bits, s/iteration. (c)
    ``solve_ba_grid`` on the flagship with ``impl="planes"`` (fused by
    default) and ``"einsum"`` (the same bits: one torch path) and with
    ``band="none"`` (the monolithic kernels, their launches counted)
    against the kernel path's banded solve: s/iteration, peak memory,
    final cost within ``GRID_IMPL_COST_RTOL``. (d) the CLI with ``--impl
    planes`` on a small synthetic rig and ``--impl xla`` on a small
    ``.bal`` (outputs under ``build/chip_smoke_cli/``, removed after).
    Returns the records."""
    import os
    import shutil

    import torch

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.io import make_bal_synthetic, make_bal_windowed_host
    from deeparc_tpu_torch.pipeline.cli import main as cli_main
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        solve_ba_grid,
    )
    from deeparc_tpu_torch.solver.tiles import solve_tiles_prepared

    print("[phase 16] the impl paths: the tile engine's xla step against "
          "the kernel path, both drivers on the torch paths, the grid's "
          "planes / einsum / band='none', --impl; float64")
    t_phase = time.time()
    rec = {}
    if tile_layout_ is None:
        tile_layout_ = tile_layout(make_bal_windowed_host(
            n_points=args.tile_points, seed=0, **TILE_SCENE), True)
    tiles, params_t, free_t, packed, cam_free = tile_layout_
    n_live = int(sum(float(b.mask.sum()) for b in tiles.buckets))
    opts = SolverOptions(linear_solver="iterative_schur",
                         cg_max_iterations=30)
    steps = {}
    for impl in ("pallas", "xla"):
        nxt, info, rec[f"step {impl}"], run = impl_step_split(
            impl, tile_layout_, opts)
        steps[impl] = (nxt, bool(info.accepted))
        if impl == "xla":
            check_step_repeats(run, "xla tile step")
            print("  xla: the step run twice: the same bits")
        del run, nxt, info
        torch.cuda.empty_cache()
    (ref, ref_acc), (got, acc) = steps["pallas"], steps["xla"]
    diffs = {f: rel_diff(getattr(got, f), getattr(ref, f))
             for f in ("cost", "points", "cam_vec")}
    rec["step xla"]["rel_to_pallas"] = diffs
    print(f"  xla against pallas: relative differences "
          + ", ".join(f"{f} {d:.3e}" for f, d in diffs.items())
          + f" (tol {IMPL_RTOL:g}); accept {acc} / {ref_acc}")
    if acc != ref_acc or max(diffs.values()) > IMPL_RTOL:
        raise AssertionError("the xla tile step strays from the kernel "
                             "path's")
    del steps, ref, got
    torch.cuda.empty_cache()

    iters, block = XLA_ITERATIONS
    run_on = dict(function_tolerance=0.0, parameter_tolerance=0.0,
                  gradient_tolerance=0.0, progress_to_stdout=False)
    xopts = SolverOptions(max_iterations=iters, **run_on,
                          linear_solver="iterative_schur",
                          cg_max_iterations=30)
    print(f"  (b) the torch paths under both drivers: "
          f"solve_tiles_prepared(impl='xla'), {iters} iterations")
    case = device_loop_case(
        "xla, windowed BAL scene", lambda driver: solve_tiles_prepared(
            params_t, tiles, free_t, cam_free, xopts, impl="xla",
            driver=driver, while_block=block), profiled=False)
    case["rmse_px"] = (2.0 * case["cost"] / n_live) ** 0.5
    print(f"    RMSE {case['rmse_px']:.6f} px after {case['iterations']} "
          f"iterations")
    rec["xla solve"] = case
    del tiles, params_t, free_t, packed, cam_free, tile_layout_
    torch.cuda.empty_cache()

    scene = from_deeparc(flagship, dtype=torch.float64, device="cuda")
    grid, free = grid_from_scene(scene), freeze_masks(scene)
    gopts = SolverOptions(max_iterations=GRID_IMPL_ITERATIONS, **run_on)
    print(f"    solve_ba_grid(impl='planes') on the occlusion flagship, "
          f"{GRID_IMPL_ITERATIONS} iterations")
    rec["planes solve"] = device_loop_case(
        "planes, occlusion flagship", lambda driver: solve_ba_grid(
            scene.params, grid, free, gopts, impl="planes", driver=driver,
            while_block=GRID_IMPL_ITERATIONS), profiled=False)
    torch.cuda.empty_cache()

    print(f"  (c) solve_ba_grid on the occlusion flagship, "
          f"{GRID_IMPL_ITERATIONS} iterations (Python driver)")
    grid_rec = {}
    for label, kw in (("kernels (banded)", {}),
                      ("planes", dict(impl="planes")),
                      ("einsum", dict(impl="einsum")),
                      ("band='none'", dict(band="none"))):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        k.reset_launch_counts()
        res = solve_ba_grid(scene.params, grid, free, gopts, **kw)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in (
            k.linearize_grid_banded, k.cost_grid_banded, k.linearize_grid,
            k.cost_grid)}
        r = dict(iterations=res.iterations, cost=res.cost,
                 s_per_iteration=res.seconds / max(res.iterations, 1),
                 peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                 launches=launches)
        base = grid_rec.get("kernels (banded)")
        if base is not None:
            r["rel_cost_to_kernels"] = abs(r["cost"] - base["cost"]) / abs(
                base["cost"])
        grid_rec[label] = r
        print(f"    {label}: {r['iterations']} iterations, cost "
              f"{r['cost']:.12e}, {r['s_per_iteration']:.6f} s/iteration, "
              f"peak {r['peak_gib']:.2f} GiB, grid kernel launches "
              f"{launches}"
              + (f", relative cost difference to the kernel path "
                 f"{r['rel_cost_to_kernels']:.3e} (tol "
                 f"{GRID_IMPL_COST_RTOL:g})" if base is not None else ""))
        if base is not None and (
                r["iterations"] != base["iterations"]
                or not r["rel_cost_to_kernels"] <= GRID_IMPL_COST_RTOL):
            raise AssertionError(f"the grid solve with {label} strays from "
                                 f"the kernel path's")
        del res
    if grid_rec["kernels (banded)"]["launches"]["linearize_grid_banded"] < 1:
        raise AssertionError("the kernel path's solve took no band")
    none = grid_rec["band='none'"]["launches"]
    if (none["linearize_grid"] < 1 or none["cost_grid"] < 1
            or none["linearize_grid_banded"] or none["cost_grid_banded"]):
        raise AssertionError(f"band='none' did not run the monolithic "
                             f"kernels alone: {none}")
    for label in ("planes", "einsum"):
        if any(grid_rec[label]["launches"].values()):
            raise AssertionError(f"impl={label} launched a grid kernel")
    if grid_rec["einsum"]["cost"] != grid_rec["planes"]["cost"]:
        raise AssertionError("impl='einsum' and 'planes' (one torch path) "
                             "gave other bits")
    rec["grid"] = grid_rec
    del scene, grid, free
    torch.cuda.empty_cache()

    print("  (d) the CLI with --impl")
    work = os.path.join("build", "chip_smoke_cli")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    bal = make_bal_synthetic(n_cameras=16, n_points=2000, pixel_noise=0.5,
                             point_noise=0.02, seed=4).data
    bal_path = os.path.join(work, "scene.bal")
    write_bal(bal_path, bal)
    cli = {}
    for label, argv in (
            ("planes", ["--synthetic", "--n-arc", "4", "--n-ring", "8",
                        "--n-points", "2000", "--impl", "planes"]),
            ("xla", [bal_path, "--impl", "xla", "--linear-solver",
                     "iterative_schur"])):
        out = os.path.join(work, label)
        t0 = time.time()
        rc = cli_main(argv + ["--max-iterations", "20", "--no-snapshots",
                              "--quiet", "-o", out])
        written = sorted(os.listdir(out)) if os.path.isdir(out) else []
        cli[label] = dict(rc=rc, seconds=time.time() - t0, written=written)
        print(f"    --impl {label}: exit {rc}, {cli[label]['seconds']:.1f} "
              f"s, wrote {written}")
        if rc != 0 or not any(f.endswith("_output.deeparc")
                              for f in written):
            raise AssertionError(f"the CLI with --impl {label} failed")
    shutil.rmtree(work)
    rec["cli"] = cli
    rec["phase_seconds"] = time.time() - t_phase
    print(f"  phase 16 took {rec['phase_seconds']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# The measurement scripts (phase 17)
# ---------------------------------------------------------------------------

# the points of phase 17's CPU anchor: one iteration at the flagship's
# 400k points takes ~90 s on one process (BENCH.md:28), too long for the
# script's time
CERES_POINTS = 40_000
# the Schur pieces of profile_grid and the trial's slot_params against the
# step's Schur part (the step less its linearize and trial cost): each
# piece alone leaves out the step's decision scalars and the gaps between
# its launches
SCHUR_SPLIT_RTOL = 0.25
# the rows of phase 17's records that may hold no time: the banded
# linearize takes tiles of at most 256 points, so profile_grid_band's
# 512-point row of it holds the wrapper's refusal
REFUSALS_ALLOWED = {"profile_grid_band": {"b512.lin"}}


def script_runs(args):
    """Phase 17's runs: (label, entry point, arguments, the hand kernels
    and helpers its run must launch)."""
    n, tp = str(args.n_points), str(args.tile_points)
    grid_mono, grid_band = ("linearize_grid", "cost_grid"), (
        "linearize_grid_banded", "cost_grid_banded")
    return (
        ("profile_grid uniform", "profile_grid", ["--n-points", n],
         grid_mono + ("schur_reduce",)),
        ("profile_grid flagship", "profile_grid",
         ["--n-points", n, "--occlusion-rings", "6"],
         grid_band + ("schur_reduce",)),
        ("profile_grid_band", "profile_grid_band", ["--n-points", n],
         grid_mono + grid_band),
        ("profile_planes", "profile_planes", [], ()),
        ("profile_tiles pallas", "profile_tiles", ["--n-points", tp],
         ("tile_linearize_local", "tile_sweep_local", "sort_jcam_planes",
          "sum_rows")),
        ("profile_tiles pallas, no window", "profile_tiles",
         ["--n-points", tp, "--window", "0"], ("tile_sweep", "sort_jcam")),
        ("profile_tiles xla", "profile_tiles",
         ["--n-points", tp, "--impl", "xla"], ("sum_rows",)),
        ("microbench_ops", "microbench_ops", [], ("sum_rows",)),
        ("microbench_tile_ops", "microbench_tile_ops", [], ("sum_rows",)),
        ("ceres_equiv_cpu", "ceres_equiv_cpu",
         ["--n-points", str(CERES_POINTS), "--reps", "1", "--procs", "1,2"],
         ()),
    )


def check_numbers(label, rec, path="", times=False):
    """Every time in a script's record (a key ``ms`` or ending in ``_ms``,
    or ``seconds_per_iter``, and every number under a key ending in
    ``_ms``) finite and above 0, every share (a key holding ``share``) at
    most ``scripts.SHARE_LIMIT``; a refused row (``refused``) holds no
    time. Returns the number of values checked."""
    import math

    from deeparc_tpu_torch.scripts import SHARE_LIMIT

    n = 0
    items = rec.items() if isinstance(rec, dict) else enumerate(
        rec if isinstance(rec, list) else ())
    for key, val in items:
        where, key = f"{path}.{key}", str(key)
        is_time = times or key == "ms" or key.endswith("_ms") \
            or key == "seconds_per_iter"
        if isinstance(val, (dict, list)):
            n += check_numbers(label, val, where, key.endswith("_ms"))
        elif not isinstance(val, (int, float)) or isinstance(val, bool):
            continue
        elif is_time:
            if not (math.isfinite(val) and val > 0):
                raise AssertionError(f"{label}: {where} = {val}")
            n += 1
        elif "share" in key:
            if not val <= SHARE_LIMIT:
                raise AssertionError(f"{label}: {where} = {val} above "
                                     f"{SHARE_LIMIT}")
            n += 1
    return n


def refusals(rec, path=""):
    """The rows of a script's record that hold a refusal or a declined
    layout (a key ``refused`` or ``declined``) in place of a time, by
    their dotted key path."""
    if not isinstance(rec, dict):
        return []
    if "refused" in rec or "declined" in rec:
        return [path]
    return [p for key, val in rec.items()
            for p in refusals(val, f"{path}.{key}" if path else str(key))]


def run_script(module, argv, timeout=600):
    """``python -m deeparc_tpu_torch.scripts.<module> <argv>`` from the
    repo's root, as a user runs it: (its JSON line, seconds)."""
    import os
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", f"deeparc_tpu_torch.scripts.{module}", *argv],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    seconds = time.time() - t0
    if res.returncode != 0:
        raise AssertionError(f"{module} {argv}: exit {res.returncode}\n"
                             f"{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1]), seconds


def phase_scripts(args):
    """Phase 17: the measurement entry points of
    ``deeparc_tpu_torch.scripts`` run as a user runs them, each in its own
    process on the card at the sizes of :func:`script_runs` (the rigs and
    the BAL scene cut with ``--n-points`` / ``--tile-points``, the CPU
    anchor at ``CERES_POINTS``); each JSON line's times finite and above
    0, its shares at most 1.05, no row without a time but those of
    ``REFUSALS_ALLOWED``, the hand kernels and helpers its run must
    launch launched (the counts its process read), ``profile_grid``'s
    Schur pieces and the trial's ``slot_params`` within
    ``SCHUR_SPLIT_RTOL`` of the step's Schur part.
    Returns the records."""
    import torch

    print("[phase 17] the measurement scripts, each in its own process")
    t_phase = time.time()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    rec = {}
    for label, module, argv, kernels in script_runs(args):
        out, seconds = run_script(module, argv)
        n = check_numbers(label, out)
        refused = set(refusals(out))
        if refused - REFUSALS_ALLOWED.get(module, set()):
            raise AssertionError(f"{label}: rows {sorted(refused)} hold no "
                                 f"time")
        missing = [kname for kname in kernels
                   if not out.get("launches", {}).get(kname, 0) > 0]
        if missing:
            raise AssertionError(f"{label}: {missing} did not launch "
                                 f"({out.get('launches')})")
        print(f"  {label} ({seconds:.1f} s; {n} times and shares checked): "
              f"{json.dumps(out)}")
        if module == "profile_grid":
            ratio = out["pieces_over_rest"]
            print(f"    Schur pieces (ms): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in
                              out["schur_ms"].items())
                  + f"; their sum {out['schur_pieces_sum_ms']:.3f} and the "
                  f"trial's slot_params {out['slot_params_ms']:.3f} against "
                  f"the step's Schur part {out['schur_rest_ms']:.3f} (step "
                  f"{out['full_step_ms']:.3f} less linearize "
                  f"{out['assemble_ms']:.3f} and trial cost "
                  f"{out['trial_cost_ms']:.3f}): {ratio:.3f}")
            if ratio is None or abs(ratio - 1.0) > SCHUR_SPLIT_RTOL:
                raise AssertionError(f"{label}: the Schur pieces and "
                                     f"slot_params sum to {ratio} of the "
                                     f"step's Schur part")
        out["script_seconds"] = seconds
        rec[label] = out
    rec["phase_seconds"] = time.time() - t_phase
    print(f"  phase 17 took {rec['phase_seconds']:.1f} s")
    return rec


def write_bal(path, data):
    """A BAL file of a non-shared synthetic scene: BAL has no principal
    point and projects with -f, so observations are shifted to the centre
    and the focal length is stored negated."""
    import numpy as np

    cam = np.concatenate([data.ext_rot, data.ext_trans, -data.focal[:, :1],
                          data.dist], axis=1)
    xy = data.obs_xy - data.center[data.obs_arc]
    with open(path, "w") as f:
        f.write(f"{cam.shape[0]} {data.n_points} {data.n_obs}\n")
        for c, p, (x, y) in zip(data.obs_arc, data.obs_point, xy):
            f.write(f"{c} {p} {x:.17g} {y:.17g}\n")
        for v in np.concatenate([cam.reshape(-1), data.points.reshape(-1)]):
            f.write(f"{v:.17g}\n")


def schur_inputs(n_points, occlusion_rings):
    """(E, binv, g_p) of the grid step at the start iterate of
    ``profile_grid``'s rig, float64: the band-prepped occlusion flagship
    (ext-only E in the kernels' native order) or the uniform rig (E with
    the intrinsic columns)."""
    import torch

    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.scripts import profile_grid as pg
    from deeparc_tpu_torch.solver.rig_grid import schur_point_blocks

    opts = SolverOptions()
    prob = pg.problem(n_points, occlusion_rings, torch.device("cuda"))
    _, state, _, lin, _ = pg.start(prob, opts)
    sys_ = lin()
    binv, _ = schur_point_blocks(sys_, state.tr.radius, prob.free.points,
                                 opts)
    return sys_.E, binv, sys_.g_p


def phase_schur(args):
    """Phase 18: the grid step's Schur reduction (``schur_reduce``,
    ``csrc/rig_schur.cu``) against its plain version on the card at the
    main path's two shapes, the banded flagship's ext-only E (400k x 3 x
    192) and the uniform rig's (400k x 3 x 240), in float64 and float32:
    corr and v within ``TOLERANCE["schur"]`` in float64 (``"float32"`` in
    float32), two runs the same bits, no (3N, Cn) temporary (the call's
    peak memory above its inputs and outputs under a tenth of E), the
    kernel's ms beside its bound (E, binv, g_p read once, corr and v
    written once; 3N Cn (Cn + 1) operations on the float64 tensor cores,
    FFMA in float32), the plain version's ms and its three pieces' (the
    reduced gradient, be = B^-1 E, the correction E2.T @ be), the host
    time of one call beside the plain version's (:func:`host_us`); then
    random ragged shapes (Cn 6, 66, 246; N 1001 and 37) against the plain
    version and twice for the same bits. Returns the records."""
    import torch

    from deeparc_tpu_torch import kernels as k

    print("[phase 18] the Schur reduction against its plain version")
    rec = {}
    for label, rings in (("banded flagship", 6), ("uniform rig", None)):
        E64, binv64, g64 = schur_inputs(args.n_points, rings)
        for dname, dtype in (("float64", torch.float64),
                             ("float32", torch.float32)):
            E, binv, g_p = (t.to(dtype) for t in (E64, binv64, g64))
            N, _, Cn = E.shape
            name = f"schur_reduce {label}"
            kern = lambda: k.schur_reduce(E, binv, g_p)
            plain = lambda: k.schur_reduce_plain(E, binv, g_p)
            before = k.schur_reduce.launches
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if k.schur_reduce.launches != before + 1:
                raise AssertionError(f"{name}: the kernel did not launch")
            if not torch.equal(got[0], got[0].T):
                raise AssertionError(f"{name}: corr is not symmetric")
            rel, ab = compare(name, dname, got, want, ("corr", "v"),
                              "schur" if dtype == torch.float64 else None)
            del got, want
            check_repeatable(name, kern)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = kern()
            torch.cuda.synchronize()
            extra = (torch.cuda.max_memory_allocated() - base
                     - nbytes(*out))
            del out
            if extra > nbytes(E) / 10:
                raise AssertionError(f"{name}: the call held {extra} bytes "
                                     f"beside its output (E is "
                                     f"{nbytes(E)})")
            esz = E.element_size()
            pieces = {
                "rhs": time_ms(lambda: E.reshape(N * 3, Cn).T @ torch.einsum(
                    "pij,pj->pi", binv, g_p).reshape(-1), args.reps),
                "be": time_ms(lambda: torch.einsum(
                    "pij,pjd->pid", binv, E), args.reps)}
            be = torch.einsum("pij,pjd->pid", binv, E).reshape(N * 3, Cn)
            pieces["corr"] = time_ms(lambda: E.reshape(N * 3, Cn).T @ be,
                                     args.reps)
            del be
            ms, plain_ms = time_ms(kern, args.reps), time_ms(plain, args.reps)
            kern_us, plain_us = host_us(kern), host_us(plain)
            moved = nbytes(E, binv, g_p) + (Cn * Cn + Cn) * esz
            ops = 3 * N * Cn * (Cn + 1)
            b_ms, b_by = bound(moved, ops, "float64_tensor"
                               if dtype == torch.float64 else "float32")
            print(f"  {name:30s} {dname}: kernel {ms:.3f} ms (bound "
                  f"{b_ms:.3f} ms by {b_by}, {b_ms / ms:.3f} of it), plain "
                  f"{plain_ms:.3f} ms; the three pieces "
                  + ", ".join(f"{p} {v:.3f}" for p, v in pieces.items())
                  + f" ms; host {kern_us:.1f} us a call (plain "
                  f"{plain_us:.1f}); extra memory {extra} bytes; bitwise "
                  f"repeatable")
            rec[f"{label}:{dname}"] = dict(
                e_shape=[N, 3, Cn], max_rel_err=rel, max_abs_err=ab, ms=ms,
                plain_ms=plain_ms, pieces_ms=pieces, bound_ms=b_ms,
                bound_by=b_by, extra_bytes=extra, host_us=kern_us,
                plain_host_us=plain_us)
            del E, binv, g_p
        del E64, binv64, g64
        torch.cuda.empty_cache()
    # ragged shapes: one tile narrower than 64 columns, a ragged last tile,
    # a last chunk of fewer than 8 points, a point count below one slice
    gen = torch.Generator(device="cuda").manual_seed(0)
    for N, Cn in ((1001, 6), (1001, 66), (37, 246)):
        E = torch.randn((N, 3, Cn), device="cuda", dtype=torch.float64,
                        generator=gen)
        a = torch.randn((N, 3, 3), device="cuda", dtype=torch.float64,
                        generator=gen)
        binv = a @ a.transpose(1, 2) + torch.eye(3, device="cuda",
                                                 dtype=torch.float64)
        g_p = torch.randn((N, 3), device="cuda", dtype=torch.float64,
                          generator=gen)
        for dname, dtype in (("float64", torch.float64),
                             ("float32", torch.float32)):
            args_ = tuple(t.to(dtype) for t in (E, binv, g_p))
            name = f"schur_reduce {N} x 3 x {Cn}"
            compare(name, dname, k.schur_reduce(*args_),
                    k.schur_reduce_plain(*args_), ("corr", "v"),
                    "schur" if dtype == torch.float64 else None)
            check_repeatable(name, lambda: k.schur_reduce(*args_))
    return rec


def new_paths(args, data, phases=(10, 11, 12, 13, 14, 15, 16, 17, 18),
              uniform=None, tile_data=None, layout=None, host_s=None):
    """Phases 10-18 (those in ``phases``) on the occlusion flagship
    ``data`` (phase 13 also on ``uniform`` and ``tile_data``, phases 14
    and 16 on phase 6's locality ``layout``, 14 also on ``uniform``, made
    here when not given; phase 15 on its generated scenes, beside the host
    scenes' seconds ``host_s``; phase 17 in processes of its own; phase 18
    on rigs of its own); their records, and the sharded paths' launches."""
    import torch

    out, sharded = {}, {}
    for n, key, phase in ((10, "indexed", phase_indexed),
                          (11, "incremental", phase_incremental),
                          (12, "resume", phase_resume)):
        if n not in phases:
            continue
        t0 = time.time()
        out[key] = phase(args, data)
        out[key]["phase_seconds"] = time.time() - t0
        torch.cuda.empty_cache()
    if 13 in phases:
        t0 = time.time()
        out["sharded"], sharded = phase_sharded(args, data, uniform,
                                                tile_data)
        out["sharded"]["phase_seconds"] = time.time() - t0
        torch.cuda.empty_cache()
    if 14 in phases:
        t0 = time.time()
        out["device_loop"] = phase_device_loop(args, data, uniform, layout)
        out["device_loop"]["phase_seconds"] = time.time() - t0
    if 15 in phases:
        torch.cuda.empty_cache()
        out["generated"] = phase_generated(args, host_s or {})
    if 16 in phases:
        torch.cuda.empty_cache()
        out["impls"] = phase_impls(args, data, layout)
    if 17 in phases:
        out["scripts"] = phase_scripts(args)
    if 18 in phases:
        torch.cuda.empty_cache()
        out["schur"] = phase_schur(args)
    return out, sharded


def kernel_record(name, rec, launches, per_step, sharded):
    """The JSON record of one kernel: the float64 numbers (a sweep's matvec
    mode, the one PCG repeats; ``sweep_payload``'s float32 many mode),
    every other measurement nested; ``launches_per_step`` is at the scene
    the kernel is timed on (0 for the probes, on no LM step);
    ``launches_sharded`` its launches on phase 13's sharded paths (0 where
    those run it not)."""
    main = next(key for key in ("float64:matvec", "float64", "float32:many")
                if key in rec)
    r = rec[main]
    probe = name in ("fma_pass", "sweep_payload")
    return dict(
        name=name, route="cuda",
        source=(PROBES_SOURCE if probe else TILE_SOURCE
                if name.startswith("tile") else BAND_SOURCE
                if name == "linearize_grid_banded" else GRID_SOURCE),
        replaces=REPLACES[name], launches=launches[name],
        launches_sharded=sharded.get(name, 0),
        max_abs_err=r["max_abs_err"], max_rel_err=r["max_rel_err"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=r.get("library_ms"),
        launches_per_step=0 if probe else per_step.get(name), measured=rec)


def schur_record(rec, launches, per_step, sharded):
    """The JSON record of the Schur reduction, as :func:`kernel_record`'s:
    the numbers of phase 18's banded flagship in float64, every shape
    nested; launches on phase 4's main path (per LM iteration there) and
    on phase 13's sharded paths. It replaces no Pallas kernel."""
    r = rec["banded flagship:float64"]
    return dict(
        name="schur_reduce", route="cuda", source=SCHUR_SOURCE,
        replaces=None, launches=launches["schur_reduce"],
        launches_sharded=sharded.get("schur_reduce", 0),
        max_abs_err=r["max_abs_err"], max_rel_err=r["max_rel_err"],
        ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
        bound_by=r["bound_by"], library_ms=None,
        launches_per_step=per_step.get("schur_reduce"), measured=rec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-points", type=int, default=400_000,
                    help="points of the 8x24-cell rigs (cut only this)")
    ap.add_argument("--tile-points", type=int, default=1_000_000,
                    help="points of the windowed BAL scene (cut only this)")
    ap.add_argument("--global-points", type=int, default=100_000,
                    help="points of phase 8's scene")
    ap.add_argument("--dense-points", type=int, default=400_000,
                    help="points of phase 9's dense rig (cut only this)")
    ap.add_argument("--max-iterations", type=int, default=100,
                    help="LM iterations per solve")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs per kernel and plain version")
    ap.add_argument("--cost-only", action="store_true",
                    help="after the build, time only the two cost wrappers "
                         "(an A/B or ablation of cost_band) and exit")
    ap.add_argument("--new-paths-only", nargs="?",
                    const="10,11,12,13,14,15,16,17,18", default=None,
                    metavar="PHASES",
                    help="after the build, run only these of phases 10-18 "
                         "(indexed engine, incremental BA, checkpoint/"
                         "resume, the sharded engines, the on-device LM "
                         "driver, the generated scenes, the impl paths, the "
                         "measurement scripts, the Schur reduction; default "
                         "all nine) and exit")
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
    t_start = time.time()

    from deeparc_tpu_torch import kernels as k
    from deeparc_tpu_torch.config import SolverOptions
    from deeparc_tpu_torch.kernels import build

    print("[phase 2] build")
    t0 = time.time()
    build.library()
    print(f"  kernels built and loaded in {time.time() - t0:.1f} s "
          f"(nvcc {build.build_seconds:.1f} s)")
    for line in build.build_log.splitlines():
        if ("registers" in line or "spill" in line or "error" in line
                or "Compiling entry" in line):
            print("  ptxas:", line.strip())

    if args.cost_only:
        phase_cost_only(args)
        return 0
    if args.new_paths_only:
        phases = [int(p) for p in args.new_paths_only.split(",")]
        # phases 15, 17 and 18 build their own scenes
        data = (flagship_rig(args.n_points, 6, 0)
                if set(phases) - {15, 17, 18} else None)
        paths, sharded = new_paths(args, data, phases)
        print(json.dumps({"paths": paths}))
        print(json.dumps({"sharded_launches": sharded}))
        print(nvidia_smi())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    records: dict = {}
    rigs, flagship_s = phase_grid_kernels(args, records)
    print("[phase 3b] one LM step on the uniform-random rig (the "
          "linearize_grid path)")
    per_step = grid_step_split(rigs[False])
    data, uniform = rigs[True], rigs[False]
    del rigs
    torch.cuda.empty_cache()

    print("[phase 4] grid main path: run_pipeline, 8x24-cell occlusion "
          "rig, float64")
    print(f"  rig: {data.n_points} points after the track filter, "
          f"{data.n_obs} observations"
          + ("" if args.n_points == 400_000 else
             f" (n_points cut from 400000 to {args.n_points})"))
    banded_step_split(data)
    # each path's counts are set to 0 just before it runs and read just after
    k.reset_launch_counts()
    res = run_main_path(data, args, "occlusion rig")
    launches = {fn.__name__: fn.launches
                for fn in (k.linearize_grid_banded, k.cost_grid_banded,
                           k.schur_reduce)}
    # the banded pair and the Schur reduction on their own scene: launches
    # per LM iteration of the pipeline, each solve's start cost included
    per_step.update({kname: n / max(res.solve_iterations, 1)
                     for kname, n in launches.items()})

    print("[phase 5] uniform-random rig through run_pipeline (monolithic)")
    from deeparc_tpu_torch.io import make_hemisphere_rig

    small = make_hemisphere_rig(n_arc=5, n_ring=12, n_points=20_000,
                                visibility=0.3, pixel_noise=PIXEL_NOISE,
                                point_noise=0.02, seed=2).data
    k.reset_launch_counts()
    run_main_path(small, args, "uniform rig")
    launches.update({fn.__name__: fn.launches
                     for fn in (k.linearize_grid, k.cost_grid)})
    launches["schur_reduce (uniform rig)"] = k.schur_reduce.launches
    print(f"  launches on the grid paths: {launches}")

    tile_data, tile_per_step, sums, layout, bal_s = phase_tile_kernels(
        args, records)
    per_step.update(tile_per_step)
    print("  launches per LM step at each kernel's timing scene: "
          + ", ".join(f"{kname} {n:.2f}" for kname, n in per_step.items()))

    print("[phase 7] tile main path: run_pipeline, windowed BAL scene, "
          "float64, ITERATIVE_SCHUR with 30 PCG iterations")
    print(f"  scene: {tile_data.n_points} points, {tile_data.n_obs} "
          f"observations"
          + ("" if args.tile_points == 1_000_000 else
             f" (n_points cut from 1000000 to {args.tile_points})"))
    k.reset_launch_counts()
    run_main_path(tile_data, args, "windowed BAL scene", SolverOptions(
        linear_solver="iterative_schur", cg_max_iterations=30,
        max_iterations=args.max_iterations))
    launches.update({fn.__name__: fn.launches
                     for fn in (k.tile_linearize_local, k.tile_sweep_local)})
    # the tile path's helpers: tile_sweep_local's chunk-sorted plane copy,
    # and the fixed-order row sums (the chunk bins of the sweeps and the
    # linearize into the cells, and the step's other sums)
    helpers = {fn.__name__: fn.launches
               for fn in (k.sort_jcam_planes, k.sum_rows)}
    print(f"  launches of the tile path's helpers: {helpers}")
    torch.cuda.empty_cache()

    print("[phase 8] solve_ba_tiles(locality=False): the tile_sweep path")
    launches["tile_sweep"] = phase_tile_global(args)
    print(f"  launches on the main paths: {launches}")

    probe_launches, probe_results = phase_probes(args, records)
    launches.update(probe_launches)
    paths, sharded = new_paths(args, data, uniform=uniform,
                               tile_data=tile_data, layout=layout,
                               host_s=dict(flagship=flagship_s, bal=bal_s))
    del tile_data, uniform, layout
    for kname, n in {**launches, **helpers}.items():
        if n <= 0:
            raise AssertionError(f"{kname} was not launched on its path")

    kernels = [kernel_record(kname, rec, launches, per_step, sharded)
               for kname, rec in records.items()]
    kernels.append(schur_record(paths["schur"], launches, per_step, sharded))
    for rec in kernels:
        if rec["name"] == "cost_grid":
            # the stack a monolithic solve builds once, which the kernel's
            # time leaves out
            rec["stack_build_ms"] = rec["measured"]["float64:split"][
                "stack_build_ms"]
        if rec["name"] == "tile_sweep_local":
            rec["helpers"] = {h: dict(launches=n,
                                      launches_per_step=per_step.get(h))
                              for h, n in helpers.items()}
            rec["helpers"]["sum_rows"]["measured"] = sums
    for mod in list(sys.modules):
        if mod in ("jax", "deeparc_tpu", "scripts") \
                or mod.startswith(("jax.", "deeparc_tpu.", "scripts.")):
            raise AssertionError(f"the port imported {mod}")
    print(f"  script {time.time() - t_start:.1f} s after the card check")
    print(json.dumps({"probes": probe_results}))
    print(json.dumps({"paths": paths}))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

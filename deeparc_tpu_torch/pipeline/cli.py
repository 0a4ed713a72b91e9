"""Command-line interface for the port's SfM pipeline.

Usage:
    python -m deeparc_tpu_torch.pipeline.cli scene.deeparc -o out/
    python -m deeparc_tpu_torch.pipeline.cli --synthetic --n-points 2000 -o out/
    python -m deeparc_tpu_torch.pipeline.cli scene.deeparc --engine indexed
    python -m deeparc_tpu_torch.pipeline.cli scene.deeparc --incremental \
        --batch-size 24
    deeparc-tpu-torch scene.bal --device cpu
    python -m deeparc_tpu_torch.pipeline.cli scene.deeparc --engine grid-sharded
    torchrun --nproc-per-node 4 -m deeparc_tpu_torch.pipeline.cli \
        scene.deeparc --engine grid-sharded --devices 4

``--device cuda`` (the default) runs the hand-written CUDA kernels and fails
if no card is present; ``--device cpu`` runs their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deeparc-tpu-torch",
        description="structure-from-motion bundle adjustment, PyTorch + "
                    "CUDA")
    p.add_argument("input", nargs="?", help=".deeparc (or .bal) input file")
    p.add_argument("-o", "--output-dir", default=None)
    p.add_argument("--basename", default=None, help="output file prefix")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda = the hand kernels (fails without a card); "
                        "cpu = their plain PyTorch versions")
    p.add_argument("--f32", action="store_true",
                   help="compute in float32 (default float64)")
    # solver (defaults: sfm.cc:66-73,111,121)
    p.add_argument("--max-iterations", type=int, default=100)
    p.add_argument("--max-seconds", type=float, default=3600.0)
    p.add_argument("--linear-solver", default="dense_schur",
                   choices=["dense_schur", "iterative_schur"],
                   help="grid engine: dense Schur; the tile engine always "
                        "solves by PCG; the indexed engine either")
    p.add_argument("--engine", default="auto",
                   choices=["auto", "grid", "indexed", "tiles",
                            "grid-sharded", "tiles-sharded"],
                   help="auto = the dense grid engine for shared rigs, the "
                        "tile engine for non-shared (BAL-style) scenes; "
                        "indexed = the observation-list engine (small "
                        "problems); grid-sharded / tiles-sharded = the grid "
                        "/ tile engine with every solve sharded over the "
                        "ranks of the process group (one device a rank; "
                        "run under torchrun for more than one)")
    p.add_argument("--devices", type=int, default=None,
                   help="sharded engines: the number of ranks, which must "
                        "be the process group's size (torchrun "
                        "--nproc-per-node N ... --devices N); without "
                        "torchrun one rank")
    p.add_argument("--sweep-dtype", default=None, choices=["f32", "bf16"],
                   help="tile engine: bf16 stores the Jacobian planes the "
                        "PCG sweeps re-read in half the bytes (every sum "
                        "stays in the working dtype)")
    p.add_argument("--impl", default="auto",
                   choices=["auto", "pallas", "planes", "einsum", "xla"],
                   help="implementation inside the engine: auto / pallas = "
                        "the hand CUDA kernels (their plain PyTorch "
                        "versions with --device cpu); planes / einsum = the "
                        "grid engine's torch paths (the tile engine runs "
                        "xla for both); xla = the tile engine's torch paths "
                        "(the grid engine runs planes)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable NaN debugging: fail loudly at the first NaN "
                        "(e.g. a point crossing z=0 in the perspective divide)")
    # filter (defaults: sfm.cc:112,122; DeepArcManager.cc:347-349,387)
    p.add_argument("--error-boundary", type=float, default=5.0)
    p.add_argument("--parity-inverted", action="store_true",
                   help="reproduce the reference's mse<threshold removal")
    p.add_argument("--no-hemisphere-cut", action="store_true")
    p.add_argument("--hemisphere-iterations", type=int, default=1000)
    p.add_argument("--no-snapshots", action="store_true")
    # synthetic problem generation
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--n-arc", type=int, default=5)
    p.add_argument("--n-ring", type=int, default=12)
    p.add_argument("--n-points", type=int, default=2000)
    p.add_argument("--pixel-noise", type=float, default=1.0)
    p.add_argument("--point-noise", type=float, default=0.05)
    p.add_argument("--random-points", action="store_true")
    p.add_argument("--occlusion-rings", type=int, default=None,
                   help="synthetic rig: self-occlusion window in turntable "
                        "steps (the banded kernels exploit it)")
    p.add_argument("--visibility", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    # incremental registration (the reference's *_bfs dataset path)
    p.add_argument("--incremental", action="store_true",
                   help="register cameras incrementally in BFS order over "
                        "the covisibility graph, bundle-adjusting per "
                        "batch (non-shared scenes add a pose-graph "
                        "refinement stage between batches)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="--incremental: cameras activated per batch "
                        "(default: one ring / C//8)")
    p.add_argument("--no-pose-graph", action="store_true",
                   help="--incremental: skip the pose-graph stage")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import os

    import torch

    from deeparc_tpu_torch.config import (
        FilterOptions,
        PipelineOptions,
        SolverOptions,
    )
    from deeparc_tpu_torch.device import check_device
    from deeparc_tpu_torch.io import (
        make_hemisphere_rig,
        read_bal_fast,
        read_deeparc_fast,
    )
    from deeparc_tpu_torch.pipeline.driver import run_pipeline

    device = check_device(args.device)
    if args.debug_nans:
        from deeparc_tpu_torch.utils.debug import set_nan_debugging

        set_nan_debugging(True)
    if args.synthetic:
        data = make_hemisphere_rig(
            n_arc=args.n_arc, n_ring=args.n_ring, n_points=args.n_points,
            pixel_noise=args.pixel_noise, point_noise=args.point_noise,
            random_points=args.random_points, seed=args.seed,
            occlusion_rings=args.occlusion_rings,
            visibility=args.visibility).data
        basename = args.basename or "synthetic"
    elif args.input:
        is_bal = args.input.endswith((".bal", ".bal.gz"))
        data = (read_bal_fast if is_bal else read_deeparc_fast)(args.input)
        basename = args.basename or os.path.splitext(
            os.path.basename(args.input))[0]
    else:
        print("error: provide an input file or --synthetic", file=sys.stderr)
        return 2

    options = PipelineOptions(
        solver=SolverOptions(max_iterations=args.max_iterations,
                             max_seconds=args.max_seconds,
                             linear_solver=args.linear_solver,
                             progress_to_stdout=not args.quiet),
        filter=FilterOptions(error_boundary=args.error_boundary,
                             parity_inverted=args.parity_inverted,
                             hemisphere_cut=not args.no_hemisphere_cut),
        hemisphere_max_iterations=args.hemisphere_iterations,
        write_snapshots=not args.no_snapshots,
        engine=args.engine,
        devices=args.devices,
        sweep_dtype=args.sweep_dtype,
        impl=args.impl,
    )
    dtype = torch.float32 if args.f32 else torch.float64
    if args.incremental:
        from deeparc_tpu_torch.io import write_deeparc
        from deeparc_tpu_torch.pipeline.incremental import run_incremental
        from deeparc_tpu_torch.scene import to_deeparc

        inc = run_incremental(data, options, batch_size=args.batch_size,
                              dtype=dtype, device=device,
                              verbose=not args.quiet,
                              pose_graph=not args.no_pose_graph)
        if args.output_dir:
            os.makedirs(args.output_dir, exist_ok=True)
            write_deeparc(to_deeparc(inc.scene), os.path.join(
                args.output_dir, f"{basename}_incremental.deeparc"))
        print(f"[deeparc] incremental done: batches={inc.batches} "
              f"cost={inc.final_cost:.6e} rmse={inc.final_rmse_px:.4f}px")
        return 0
    result = run_pipeline(
        data, options, output_dir=args.output_dir, basename=basename,
        dtype=dtype, device=device, verbose=not args.quiet)
    print(f"[deeparc] done: rounds={result.filter_rounds} "
          f"cost={result.final_cost:.6e} rmse={result.final_rmse_px:.4f}px")
    return 0


if __name__ == "__main__":
    sys.exit(main())

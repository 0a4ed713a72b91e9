"""The control of ``correct``: the plain reference computed in float32,
the precision below the configurations' float64, put in the program's
place and judged by the cell's own comparison against the float64
reference. Every cell's limits must refuse it.

    python3 -m portbench.control --workload rig-occl.solve --seeds 1 2 3

prints one JSON line a seed with the gaps the cell's comparison reads
and whether its limits refuse them. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_gaps(workload: str, seed: int, device: str = "cuda",
                 overrides: dict | None = None,
                 seconds: dict | None = None) -> dict:
    """The cell's gaps of the float32 reference's answer against the
    float64 reference's, on the scene of ``seed``; ``seconds`` receives
    each reference's time."""
    import torch

    from portbench import answers, generate
    from portbench.run import load_cell, load_module

    _, _, cell, cfg, traffic = load_cell(workload, overrides)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    data = generate.make(cfg, traffic, seed, dev)
    ctx = {"config": cfg, "traffic": traffic, "cell": cell, "data": data,
           "device": dev, "seed": seed, "start": answers.start_of(
               data, cfg.get("free_intrinsics", ()))}
    entry = load_module("entries", cell["entry"])
    seconds = {} if seconds is None else seconds
    t0 = time.perf_counter()
    exact = entry.reference(ctx, torch.float64)
    t1 = time.perf_counter()
    low = entry.reference(ctx, torch.float32)
    seconds.update(float64=t1 - t0, float32=time.perf_counter() - t1)
    return entry.gaps(low, exact, ctx)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--scene-seed", type=int, default=None,
                   help="draw the scene of a configuration that fixes its "
                   "scene_seed from this one instead")
    args = p.parse_args(argv)
    overrides = (None if args.scene_seed is None else
                 {"config": {"scene_seed": args.scene_seed}})
    from portbench.run import load_cell

    limits = load_cell(args.workload)[2]["limits"]
    for seed in args.seeds:
        seconds: dict = {}
        gaps = control_gaps(args.workload, seed, overrides=overrides,
                            seconds=seconds)
        refused = [k for k, v in gaps.items() if not v <= limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "scene_seed": args.scene_seed,
                          "gaps": gaps, "refused_by": refused,
                          "reference_s": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

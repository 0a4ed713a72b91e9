"""Measure the card's elementwise FMA ceiling and place the grid engine's
dense-rig linearize on it.

    python -m deeparc_tpu_torch.scripts.vpu_roofline [--n-points N]
    python -m deeparc_tpu_torch.scripts.vpu_roofline --device cpu \\
        --n-points 100                         # plain versions, small

The grid linearize is elementwise plane arithmetic, so its ceiling is the
FMA rate outside the tensor cores. ``kernels.probes.fma_pass`` streams a
(256, 262144) plane once and runs 512 FMAs on every element, in float32
and float64; its operations over its time are the measured ceiling, and
their share of the data sheet's peak must not pass 1.05 (a count error).
Then the port's ``linearize_grid`` is timed on the dense rig (8 x 24
cells, full visibility, 400k points, seed 0; ``--n-points`` cuts it), its
operations counted over the live slots at ``OPS_PER_SLOT``, and its rate
placed against the measured ceiling and the published peak; a share above
1.0 is a count error and raises. Each time is the median of 5 runs. On the
CPU the FMA plane is (256, 1024). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.kernels import probes
from deeparc_tpu_torch.scripts import (
    OPS_PER_SLOT,
    PEAK_FLOPS,
    card_fields,
    time_ms,
)

DENSE_POINTS = 400_000
FMA_ELEMENTS = probes.FMA_ROWS * probes.FMA_COLS * probes.FMA_TILES
CPU_FMA_ELEMENTS = probes.FMA_ROWS * 1024
REPS = 5
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def dense_rig(n_points: int, seed: int = 0):
    """The dense rig of ``bench.py --dense``: 8 arcs x 24 rings, every
    point seen by every camera, one pixel of noise."""
    from deeparc_tpu_torch.io import make_hemisphere_rig

    return make_hemisphere_rig(n_arc=8, n_ring=24, n_points=n_points,
                               visibility=1.0, pixel_noise=1.0,
                               point_noise=0.02, seed=seed).data


def linearize_inputs(data, dtype, device):
    """``linearize_grid``'s arguments for a rig, as the grid solver gives
    them: the pipeline's full-BA free mask (gauge extrinsic and intrinsics
    frozen)."""
    from deeparc_tpu_torch.residuals.reprojection import flatten_camera
    from deeparc_tpu_torch.scene import freeze_masks, from_deeparc
    from deeparc_tpu_torch.solver.rig_grid import (
        grid_from_scene,
        slot_free,
        slot_params,
    )

    scene = from_deeparc(data, dtype=dtype, device=device)
    grid = grid_from_scene(scene)
    free = freeze_masks(scene)
    sp = slot_params(scene.params, grid)
    return ((scene.params.points, free.points, sp, grid)
            + slot_free(flatten_camera(free), grid))


def measure_fma(n: int, dtype, device, seed: int = 0) -> dict:
    """The FMA ceiling: ``fma_pass`` over an (256, n / 256) plane of
    uniform values in [-1, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((probes.FMA_ROWS, n // probes.FMA_ROWS), dtype=dtype,
                   device=device, generator=gen) * 2 - 1
    ms = time_ms(lambda: probes.fma_pass(x), REPS, device)
    return {"ms": ms, "tflops": probes.fma_ops(x.numel()) / ms / 1e9}


def place_linearize(data, dtype, device) -> dict:
    """``linearize_grid``'s time on a rig, given the plane stack a solve
    builds once (``mono_stack``), and its rate over the live slots."""
    from deeparc_tpu_torch.kernels import linearize_grid
    from deeparc_tpu_torch.solver.rig_grid import mono_stack

    args = linearize_inputs(data, dtype, device)
    live = int(args[3].mask.sum())
    pxm = mono_stack(args[3], (256, 1024))
    ms = time_ms(lambda: linearize_grid(*args, block_np=256, pxm=pxm), REPS,
                 device)
    ops = live * OPS_PER_SLOT["linearize_grid"]
    return {"ms": ms, "live_slots": live, "tflops": ops / ms / 1e9}


def run(device="cuda", n_points: int = DENSE_POINTS) -> dict:
    """The measurement as a dict (the JSON line's fields); raises where a
    share on the card passes its limit."""
    device = check_device(device)
    on_card = device.type == "cuda"
    elements = FMA_ELEMENTS if on_card else CPU_FMA_ELEMENTS
    out = {}
    data = dense_rig(n_points)
    for name, dtype in DTYPES.items():
        sfx = "f32" if name == "float32" else "f64"
        fma = measure_fma(elements, dtype, device)
        lin = place_linearize(data, dtype, device)
        share = lin["tflops"] / fma["tflops"]
        out.update({
            f"fma_peak_tflops_{sfx}": fma["tflops"],
            f"fma_ms_{sfx}": fma["ms"],
            f"dense_lin_ms_{sfx}": lin["ms"],
            f"dense_lin_tflops_{sfx}": lin["tflops"],
            f"dense_lin_vs_fma_peak_{sfx}": share,
        })
        if on_card:
            fma_pub = fma["tflops"] * 1e12 / PEAK_FLOPS[name]
            lin_pub = lin["tflops"] * 1e12 / PEAK_FLOPS[name]
            out[f"fma_vs_published_peak_{sfx}"] = fma_pub
            out[f"dense_lin_vs_published_peak_{sfx}"] = lin_pub
            if fma_pub > 1.05:
                raise AssertionError(
                    f"fma_pass {name}: {fma['tflops']:.3f} TFLOP/s is "
                    f"{fma_pub:.3f} of the published peak: the count is "
                    f"wrong")
            if share > 1.0 or lin_pub > 1.0:
                raise AssertionError(
                    f"linearize_grid {name}: {lin['tflops']:.3f} TFLOP/s is "
                    f"{share:.3f} of the measured FMA ceiling and "
                    f"{lin_pub:.3f} of the published peak: the count is "
                    f"wrong")
    out.update(dense_live_slots=lin["live_slots"], n_points=n_points,
               fma_elements=elements,
               ops_per_slot=OPS_PER_SLOT["linearize_grid"],
               **card_fields(device))
    if n_points != DENSE_POINTS:
        out["cut"] = f"n_points cut from {DENSE_POINTS} to {n_points}"
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--n-points", type=int, default=DENSE_POINTS,
                    help="points of the dense rig (cut only this)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, args.n_points)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

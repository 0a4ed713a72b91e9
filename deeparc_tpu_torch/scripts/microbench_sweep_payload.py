"""Time the tile sweeps' binning contraction: a narrow (128, 18) output
over a very deep reduction.

    python -m deeparc_tpu_torch.scripts.microbench_sweep_payload
    python -m deeparc_tpu_torch.scripts.microbench_sweep_payload \\
        --device cpu                             # plain versions, 2 tiles

``kernels.probes.sweep_payload`` forms, for each of 977 tiles of 8192
columns (~1M rows at block 1024), the (128, 1024) x (1024, 18) products
of the sweeps' binning shape: as eight depth-1024 products summed in order
(``many``) and as one depth-8192 product (``one``), on float32 inputs made
from a seed (2 tiles on the CPU). Prints one JSON line: each mode's time
(the median of 5 runs) and rate, and the bound (the inputs read once and
the output written once at the memory rate, against the operations at the
float32 peak).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from deeparc_tpu_torch.device import check_device
from deeparc_tpu_torch.kernels import probes
from deeparc_tpu_torch.scripts import bound, card_fields, time_ms

CPU_TILES = 2
REPS = 5


def payload_inputs(n_tiles: int, device, seed: int = 0):
    """a (128, T * 8192) and b (18, T * 8192), uniform in [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n = n_tiles * probes.DEPTH
    a = torch.rand((probes.VL, n), device=device, generator=gen)
    b = torch.rand((probes.P, n), device=device, generator=gen)
    return a, b


def payload_bound(n_tiles: int):
    """(bound_ms, bound_by) of one call over n_tiles tiles."""
    nbytes = 4 * n_tiles * (probes.DEPTH * (probes.VL + probes.P)
                            + probes.VL * probes.P)
    return bound(nbytes, probes.payload_ops(n_tiles), "float32")


def run(device="cuda") -> dict:
    """The measurement as a dict (the JSON line's fields)."""
    device = check_device(device)
    n_tiles = probes.PAYLOAD_TILES if device.type == "cuda" else CPU_TILES
    a, b = payload_inputs(n_tiles, device)
    ops = probes.payload_ops(n_tiles)
    ms = {mode: time_ms(lambda: probes.sweep_payload(a, b, mode), REPS,
                        device)
          for mode in ("many", "one")}
    b_ms, b_by = payload_bound(n_tiles)
    return {
        "shape": (f"({probes.VL},{probes.BLOCK})x({probes.BLOCK},{probes.P})"
                  f" xW={probes.W}, {n_tiles} tiles"),
        "tflops_many_small_matmuls": ops / ms["many"] / 1e9,
        "tflops_one_batched_matmul": ops / ms["one"] / 1e9,
        "ms_many": ms["many"], "ms_one": ms["one"],
        "bound_ms": b_ms, "bound_by": b_by, **card_fields(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

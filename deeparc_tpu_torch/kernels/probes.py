"""Measurement probes: the elementwise FMA pass and the tile sweeps'
narrow-output contraction, as CUDA kernels for Hopper, with their plain
PyTorch versions.

PyTorch port of the two Pallas kernels in the repository's ``scripts/``:

  fma_pass(x)                 <- scripts/vpu_roofline.py ``_fma_pass``
  sweep_payload(a, b, mode)   <- scripts/microbench_sweep_payload.py ``_run``

They sit on no path of the solver: the entry points
``deeparc_tpu_torch.scripts.vpu_roofline`` and
``deeparc_tpu_torch.scripts.microbench_sweep_payload`` time them to measure
the card. A wrapper given CUDA tensors launches its kernel
(``csrc/probes.cu``) and raises if it cannot; given CPU tensors it runs
the plain version (``*_plain``). Each counts its launches in ``launches``.

``fma_pass`` keeps the probe's arithmetic per element (8 chains
``a_i = v (1 + 0.001 i)``, then 64 x ``a_i = a_i v + v``, out the sum of
the chains in order); the kernel fuses each multiply-add into one FMA, one
rounding, as XLA's CPU backend does with the Pallas body; the plain
version rounds the product and the sum separately. ``sweep_payload``
computes every grid tile's (128, 18) product ``a[:, tile] b[:, tile]^T``
over 8192 columns into a (T, 128, 18) output; the Pallas probe's output
block is the same for every grid step and its bodies assign, so it returns
only the last tile's, ``sweep_payload(a, b)[-1]``. Mode ``many`` sums the
tile's eight depth-1024 products in order (``_kern_many``), ``one`` forms
one depth-8192 product (``_kern_one``).
"""

from __future__ import annotations

import torch

from deeparc_tpu_torch.kernels.rig_grid import _DTYPE_IDS, _dispatch

# _fma_pass: FMAs per element, independent chains, and the script's shape
CHAIN, CHAINS = 512, 8
FMA_ROWS, FMA_COLS, FMA_TILES = 256, 512, 512
# _run: output rows, block depth, blocks per tile, output columns, tiles
VL, BLOCK, W, P = 128, 1024, 8, 18
DEPTH = W * BLOCK
PAYLOAD_TILES = 977
_MODES = {"many": 0, "one": 1}


def fma_ops(n: int) -> int:
    """Operations of fma_pass over n elements (an FMA counts two)."""
    return 2 * CHAIN * n


def payload_ops(n_tiles: int) -> int:
    """Operations of sweep_payload over n_tiles tiles."""
    return 2 * VL * P * DEPTH * n_tiles


def fma_pass_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fma_pass`."""
    accs = [x * (1.0 + 0.001 * i) for i in range(CHAINS)]
    for _ in range(CHAIN // CHAINS):
        accs = [a * x + x for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def fma_pass(x: torch.Tensor) -> torch.Tensor:
    """The FMA probe over every element of ``x`` (float32 or float64, any
    shape): 512 FMAs an element in 8 independent chains."""
    if not _dispatch(x, "fma_pass"):
        return fma_pass_plain(x)
    from deeparc_tpu_torch.kernels.build import check, library

    if x.dtype not in _DTYPE_IDS:
        raise TypeError(f"fma_pass takes float32 or float64, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fma_pass takes a contiguous tensor")
    out = torch.empty_like(x)
    fma_pass.launches += 1
    check(library().probe_fma_pass(
        _DTYPE_IDS[x.dtype], x.data_ptr(), x.numel(), out.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream), "probe_fma_pass")
    return out


def _tiles(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != VL or b.shape[0] != P:
        raise ValueError(f"a must be ({VL}, N) and b ({P}, N), not "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[1] != b.shape[1] or a.shape[1] % DEPTH:
        raise ValueError(f"a and b must share N, a multiple of {DEPTH}, not "
                         f"{a.shape[1]} and {b.shape[1]}")
    return a.shape[1] // DEPTH


def sweep_payload_plain(a: torch.Tensor, b: torch.Tensor,
                        mode: str = "many") -> torch.Tensor:
    """Plain PyTorch version of :func:`sweep_payload`: einsums over the
    tile views."""
    T = _tiles(a, b)
    if mode == "one":
        return torch.einsum("rtk,ctk->trc", a.reshape(VL, T, DEPTH),
                            b.reshape(P, T, DEPTH))
    if mode != "many":
        raise ValueError(f"unknown mode {mode!r}")
    av, bv = a.reshape(VL, T, W, BLOCK), b.reshape(P, T, W, BLOCK)
    out = torch.einsum("rtk,ctk->trc", av[:, :, 0], bv[:, :, 0])
    for w in range(1, W):
        out = out + torch.einsum("rtk,ctk->trc", av[:, :, w], bv[:, :, w])
    return out


def sweep_payload(a: torch.Tensor, b: torch.Tensor,
                  mode: str = "many") -> torch.Tensor:
    """Per tile t of 8192 columns, ``a[:, tile] @ b[:, tile].T``: a (128,
    T * 8192) and b (18, T * 8192) float32 give (T, 128, 18)."""
    if not _dispatch(a, "sweep_payload"):
        return sweep_payload_plain(a, b, mode)
    from deeparc_tpu_torch.kernels.build import check, library

    T = _tiles(a, b)
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    for t in (a, b):
        if t.dtype != torch.float32 or t.device != a.device:
            raise TypeError(f"sweep_payload takes float32 on {a.device}, "
                            f"not {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("sweep_payload takes contiguous, 16-byte "
                             "aligned inputs")
    out = torch.empty((T, VL, P), dtype=torch.float32, device=a.device)
    sweep_payload.launches += 1
    check(library().probe_sweep_payload(
        _MODES[mode], a.data_ptr(), b.data_ptr(), T, out.data_ptr(),
        torch.cuda.current_stream(a.device).cuda_stream),
        "probe_sweep_payload")
    return out


PROBE_WRAPPERS = (fma_pass, sweep_payload)
for _fn in PROBE_WRAPPERS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    for fn in PROBE_WRAPPERS:
        fn.launches = 0

"""Measurement entry points of the port, and what they share with
``chip_smoke.py``: the card's published peaks, the operations a kernel does
per slot, the bound of a piece of work, CUDA-event timing, the device's
idle share over a window of its own clock, and the card's ``nvidia-smi``
line.

    python -m deeparc_tpu_torch.scripts.vpu_roofline            # the card
    python -m deeparc_tpu_torch.scripts.microbench_sweep_payload
    python -m deeparc_tpu_torch.scripts.dual_sweeps
    python -m deeparc_tpu_torch.scripts.profile_grid [--occlusion-rings 6]
    python -m deeparc_tpu_torch.scripts.profile_grid_band
    python -m deeparc_tpu_torch.scripts.profile_planes
    python -m deeparc_tpu_torch.scripts.profile_tiles [--rig] [--impl xla]
    python -m deeparc_tpu_torch.scripts.microbench_ops
    python -m deeparc_tpu_torch.scripts.microbench_tile_ops
    ... --device cpu    # the plain versions, at a small size (tests)
    python -m deeparc_tpu_torch.scripts.ceres_equiv_cpu   # the host CPU

Each prints one JSON line. On the card the first two time the
hand-written probe kernels of ``kernels/probes.py``, the third the
reference's camera-major dual sweeps against the tile sweep kernels, the
profiles the pieces of the grid and tile LM steps, the two microbenches
library primitives (gather, scatter-add, segment sums, one-hot binning)
at the tile layout's sizes; ``--device cpu`` runs the plain versions and
times the CPU, which says nothing about the card. ``ceres_equiv_cpu`` is
the CPU DENSE_SCHUR anchor: numpy and scipy on the host, no device.
"""

from __future__ import annotations

import statistics
import subprocess
import time

# NVIDIA's data sheet, H100 SXM: device memory rate, and the peak rates
# outside the tensor cores (bf16: the tensor cores' dense rate, the only
# one it has; float64_tensor: the float64 tensor cores, mma.sync); they
# assume the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12, "bfloat16": 989e12,
              "float64_tensor": 67e12}
# operations per (point, cell) slot, counted from the arithmetic of
# csrc/rig_slot.cuh and the kernels: the slot chain ~60, its Jacobian ~240,
# the point sums ~36; the grid linearize adds ~144 for the E row and ~270
# for the slot Gram, the tile linearize ~570 for the 189 bin values; a
# matvec sweep ~170 (E v, B^-1, E^T w), rhs ~90, edot ~84
OPS_PER_SLOT = {"linearize_grid_banded": 750, "linearize_grid": 750,
                "cost_grid_banded": 60, "cost_grid": 60,
                "tile_linearize_local": 906, "rhs": 90, "matvec": 170,
                "edot": 84}


# the most a measured rate may show of its data-sheet rate before the count
# behind it is taken for wrong
SHARE_LIMIT = 1.05


def bound(nbytes_moved, ops, dtype_name):
    """(bound_ms, bound_by) of work moving these bytes and doing these ops:
    the larger of the bytes over the memory rate and the operations over
    the peak rate of their type."""
    t_bytes = nbytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cost_band_bytes(pts, stacks, n_rows):
    """The bytes ``cost_band`` must read: each stack's mask plane whole, the
    xy planes' 32-byte sectors that hold a live slot (it loads xy only for a
    live slot), counted from the masks on the card, the points, and the 30
    table columns of its chain for the ``n_rows`` table rows it reads."""
    esz = pts.element_size()
    per = 32 // esz
    total = 3 * pts.shape[0] * esz + n_rows * 30 * esz
    for pxm in stacks:
        w, cols = pxm.shape[1:]
        live = pxm[2].reshape(w, cols // per, per).ne(0).any(-1)
        total += pxm[2].numel() * esz + 2 * 32 * int(live.sum())
    return total


def band_rows(starts, groups):
    """The distinct rows of the cyclically extended table that the tiles'
    bands read: rows [starts[t] * 8, starts[t] * 8 + w) of each tile t of
    each width group (w, lo, hi)."""
    import torch

    rows = [(starts[lo:hi].long()[:, None] * 8
             + torch.arange(w, device=starts.device)).reshape(-1)
            for w, lo, hi in groups if hi > lo]
    return int(torch.cat(rows).unique().numel())


def check_share(label: str, share: float) -> float:
    """``share`` (a measured rate over its data-sheet rate), raising above
    :data:`SHARE_LIMIT`: the bytes or operations counted for it are
    wrong."""
    if share > SHARE_LIMIT:
        raise AssertionError(f"{label}: {share:.3f} of the data-sheet rate "
                             f"is above {SHARE_LIMIT}: its count is wrong")
    return share


def launch_counts() -> dict:
    """{wrapper name: launches} of every kernel wrapper of the system's
    paths and of the tile path's helpers (``sort_jcam``,
    ``sort_jcam_planes``, ``sum_rows``), as counted since the last
    ``kernels.reset_launch_counts()``."""
    from deeparc_tpu_torch import kernels
    from deeparc_tpu_torch.kernels import tile

    return {fn.__name__: fn.launches
            for fn in kernels.KERNEL_WRAPPERS + tile.HELPERS}


def busy_in(intervals, lo: float, hi: float) -> float:
    """The time of the window [lo, hi] that the (start, end) intervals
    cover: their union, each clipped to the window. The intervals and the
    window must come from one clock (the device's)."""
    busy, cur_lo, cur_hi = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur_hi is not None and a <= cur_hi:
            cur_hi = max(cur_hi, b)
            continue
        if cur_hi is not None:
            busy += cur_hi - cur_lo
        cur_lo, cur_hi = a, b
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    return busy


def idle_share(busy: float, window: float) -> float:
    """The device's idle share 1 - busy / window of a window it was busy
    ``busy`` of; a share outside [0, 1] (past float rounding) means the two
    were not measured over one window on one clock, and raises."""
    if not window > 0:
        raise ValueError(f"an idle share over an empty window ({window})")
    share = 1.0 - busy / window
    if not -1e-9 <= share <= 1.0:
        raise ValueError(f"idle share {share} outside [0, 1]: device busy "
                         f"{busy} of a {window} window")
    return max(share, 0.0)


def loop_window(loop, runtime, device, first_launch=None):
    """The device-clock window of a loop that the host ran over ``loop`` =
    (start, end) on the host's clock: ``runtime`` holds the host's runtime
    calls (host start, correlation id, name), ``device`` the device's
    activities (start, end, correlation id) on the device's clock. The
    calls made inside the loop select, by correlation id, the activities
    they launched; the window runs from the first of those to start to
    the last to end. With ``first_launch`` (e.g. "cudaGraphLaunch") it
    starts instead with the first activity after the work that the loop's
    calls before its first such call launched (a graph's warm-up step),
    so it needs no correlation id of a graph's own kernels. None when no
    call of the loop launched an activity."""
    inside = [(t, cid, name) for t, cid, name in runtime
              if loop[0] <= t <= loop[1]]
    ids = {cid for _, cid, _ in inside}
    ends = [b for _, b, cid in device if cid in ids]
    if not ends:
        return None
    hi = max(ends)
    if first_launch is None:
        return min(a for a, _, cid in device if cid in ids), hi
    launches = [t for t, _, name in inside if name == first_launch]
    if not launches:
        return None
    before = {cid for t, cid, _ in inside if t < min(launches)}
    after = max((b for _, b, cid in device if cid in before), default=None)
    starts = [a for a, _, _ in device if after is None or a >= after]
    return (min(starts), hi) if starts else None


def nvidia_smi() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout else "n/a"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi: not available"


def card_fields(device) -> dict:
    """The platform, device name and power limit a result was taken on."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "device": "cpu", "power_limit": None}
    smi = nvidia_smi().split(", ")
    return {"platform": "gpu", "device": torch.cuda.get_device_name(device),
            "power_limit": smi[1] if len(smi) == 2 else None}


def time_ms(fn, reps, device=None):
    """Median milliseconds of ``fn`` after one warm-up call: CUDA events on
    the card, the host clock on the CPU."""
    import torch

    fn()
    if device is not None and device.type == "cpu":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
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

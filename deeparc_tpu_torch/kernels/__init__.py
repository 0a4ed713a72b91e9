from deeparc_tpu_torch.kernels import graph_loop as _graph_loop
from deeparc_tpu_torch.kernels import probes as _probes
from deeparc_tpu_torch.kernels import rig_grid as _rig_grid
from deeparc_tpu_torch.kernels import tile as _tile
from deeparc_tpu_torch.kernels.probes import (
    PROBE_WRAPPERS,
    fma_pass,
    fma_pass_plain,
    sweep_payload,
    sweep_payload_plain,
)
from deeparc_tpu_torch.kernels.rig_grid import (
    cost_grid,
    cost_grid_banded,
    cost_grid_banded_plain,
    cost_grid_plain,
    flat_of_native,
    linearize_grid,
    linearize_grid_banded,
    linearize_grid_banded_plain,
    linearize_grid_plain,
    native_of_flat,
    schur_reduce,
    schur_reduce_plain,
)
from deeparc_tpu_torch.kernels.tile import (
    MAX_KERNEL_WIDTH,
    MAX_LIN_WIDTH,
    chunk_gather,
    gather_map,
    pack_bucket_planes,
    slot_bins,
    sort_jcam,
    sort_jcam_plain,
    sort_jcam_planes,
    sort_jcam_planes_plain,
    sum_chunk_bins,
    sum_rows,
    sum_rows_plain,
    tile_linearize_local,
    tile_linearize_local_plain,
    tile_sweep,
    tile_sweep_local,
    tile_sweep_local_plain,
    tile_sweep_plain,
)

# every kernel wrapper of the system's paths, each with its ``launches``
# count; the measurement probes' wrappers are PROBE_WRAPPERS
KERNEL_WRAPPERS = _rig_grid.KERNEL_WRAPPERS + _tile.KERNEL_WRAPPERS


def reset_launch_counts() -> None:
    _rig_grid.reset_launch_counts()
    _tile.reset_launch_counts()
    _probes.reset_launch_counts()
    _graph_loop.reset_launch_counts()


__all__ = [
    "KERNEL_WRAPPERS", "MAX_KERNEL_WIDTH", "MAX_LIN_WIDTH", "PROBE_WRAPPERS",
    "chunk_gather", "cost_grid", "cost_grid_banded", "cost_grid_banded_plain",
    "cost_grid_plain", "flat_of_native", "fma_pass", "fma_pass_plain",
    "gather_map", "linearize_grid",
    "linearize_grid_banded", "linearize_grid_banded_plain",
    "linearize_grid_plain", "native_of_flat", "pack_bucket_planes",
    "reset_launch_counts", "schur_reduce", "schur_reduce_plain",
    "slot_bins", "sort_jcam", "sort_jcam_plain",
    "sort_jcam_planes", "sort_jcam_planes_plain", "sum_chunk_bins",
    "sum_rows", "sum_rows_plain", "sweep_payload",
    "sweep_payload_plain", "tile_linearize_local",
    "tile_linearize_local_plain", "tile_sweep", "tile_sweep_local",
    "tile_sweep_local_plain", "tile_sweep_plain",
]

from deeparc_tpu_torch.kernels.rig_grid import (
    KERNEL_WRAPPERS,
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
    reset_launch_counts,
)

__all__ = [
    "KERNEL_WRAPPERS", "cost_grid", "cost_grid_banded",
    "cost_grid_banded_plain", "cost_grid_plain", "flat_of_native",
    "linearize_grid", "linearize_grid_banded", "linearize_grid_banded_plain",
    "linearize_grid_plain", "native_of_flat", "reset_launch_counts",
]

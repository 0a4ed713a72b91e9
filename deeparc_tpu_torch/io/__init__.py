"""I/O and synthetic problems.

The port's own copies of the reference package's ``.deeparc`` / PLY / BAL
readers and writers, the ctypes binding to the repo's native parser
(``native/``), the numpy problem generators, and the device-side
generators that build a problem in a solver's layout on the card (they
import torch and the solver when called, so importing ``io`` needs
neither); nothing here imports ``deeparc_tpu``.
"""

from deeparc_tpu_torch.io.bal import read_bal
from deeparc_tpu_torch.io.deeparc_format import (
    DeepArcData,
    read_deeparc,
    write_deeparc,
)
from deeparc_tpu_torch.io.native import read_bal_fast, read_deeparc_fast
from deeparc_tpu_torch.io.ply import write_ply
from deeparc_tpu_torch.io.synthetic import (
    SyntheticRig,
    make_bal_heavytail_device,
    make_bal_synthetic,
    make_bal_tile_device,
    make_bal_windowed_host,
    make_grid_rig_device,
    make_hemisphere_rig,
    make_tile_rig_device,
)

__all__ = [
    "DeepArcData", "read_deeparc", "write_deeparc", "read_deeparc_fast",
    "read_bal", "read_bal_fast", "write_ply", "SyntheticRig",
    "make_hemisphere_rig", "make_bal_synthetic", "make_bal_windowed_host",
    "make_grid_rig_device", "make_tile_rig_device", "make_bal_tile_device",
    "make_bal_heavytail_device",
]

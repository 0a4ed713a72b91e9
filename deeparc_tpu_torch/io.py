"""Host-side I/O, shared with the reference package.

The ``.deeparc`` / PLY / BAL readers and writers and the numpy rig
generator of ``deeparc_tpu.io`` are plain numpy (they never import JAX),
so the port re-exports them instead of copying them.
"""

from deeparc_tpu.io.deeparc_format import DeepArcData, read_deeparc, write_deeparc
from deeparc_tpu.io.native import read_bal_fast, read_deeparc_fast
from deeparc_tpu.io.ply import write_ply
from deeparc_tpu.io.synthetic import SyntheticRig, make_hemisphere_rig

__all__ = [
    "DeepArcData", "read_deeparc", "write_deeparc", "read_deeparc_fast",
    "read_bal_fast", "write_ply", "SyntheticRig", "make_hemisphere_rig",
]

"""deeparc_tpu_torch — the PyTorch + CUDA port of ``deeparc_tpu``.

Runs the shared-rig main path (``pipeline.run_pipeline`` on the grid engine)
on an NVIDIA Hopper card. The JAX package ``deeparc_tpu`` stays beside it as
the reference the port is tested against; this package never imports JAX.
It reuses the numpy-only modules of the reference (``.deeparc`` / PLY / BAL
I/O, the numpy rig generator, the option dataclasses) as they are.

Layer map (mirrors ``deeparc_tpu``):
  geometry/   rotations, projection model, camera centers
  scene       dataclasses of tensors (BAParams, SceneIndex, Scene)
  residuals/  reprojection + hemisphere residuals
  solver/     losses, trust region, small linear algebra, LM, grid engine,
              live-band prep
  kernels/    the hand-written Hopper kernels (CUDA C++ under csrc/) with
              their plain PyTorch versions
  pipeline/   hemisphere fit -> freeze solve -> filter loop driver, CLI
"""

import torch

# Every float32 matrix product and convolution runs in full float32: TF32
# keeps about three decimal digits, which the LM accept test and the parity
# tolerances against the float64 reference cannot absorb.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

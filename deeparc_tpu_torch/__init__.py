"""deeparc_tpu_torch — the PyTorch + CUDA port of ``deeparc_tpu``.

Runs ``pipeline.run_pipeline`` on an NVIDIA Hopper card: shared-extrinsic
rigs on the grid engine, non-shared (BAL-style) scenes on the tile engine,
any scene on the indexed (observation-list) engine; and
``pipeline.incremental.run_incremental`` (BFS incremental BA, with the
pose graph on non-shared scenes); the sharded engines run the same loop
over the ranks of a process group.
The JAX package ``deeparc_tpu`` stays beside it as the reference the port
is tested against; this package imports neither JAX nor ``deeparc_tpu``
and keeps its own copies of the numpy I/O, the problem generators and the
option dataclasses.

Layer map (mirrors ``deeparc_tpu``):
  io/         .deeparc / PLY / BAL I/O, native parser binding, generators
  geometry/   rotations, projection model, camera centers
  scene       dataclasses of tensors (BAParams, SceneIndex, Scene)
  residuals/  reprojection residuals and Jacobian blocks, hemisphere
              residuals, the pose graph
  solver/     losses, trust region, small linear algebra and PCG, LM, the
              indexed engine (Schur over the observation list), the grid
              engine with its live-band prep, the tile engine, the
              on-device LM driver (driver="while_loop": CUDA graphs with
              conditional WHILE nodes)
  kernels/    the hand-written Hopper kernels (CUDA C++ under csrc/) with
              their plain PyTorch versions
  pipeline/   hemisphere fit -> freeze solve -> filter loop driver, BFS
              incremental BA, CLI
  parallel/   the sharded engines on torch.distributed (one process per
              device): grid, tile and indexed solves, multi-host meshes
  utils/      solver-state checkpoints, JSONL logger, phase timers
"""

import torch

# Every float32 matrix product and convolution runs in full float32: TF32
# keeps about three decimal digits, which the LM accept test and the parity
# tolerances against the float64 reference cannot absorb.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

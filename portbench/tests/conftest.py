"""The benchmark's own tests: tiny cells through the program's plain
PyTorch paths on the CPU. A test marked ``card`` needs a CUDA card and
skips without one; it decides inside its fixture, never at import."""

import pytest
import torch

# one thread a worker: several workers' OpenMP threads spinning on shared
# cores make the small CPU solves many times slower
torch.set_num_threads(1)

# the cells cut to a size the CPU solves in seconds; the widths (cameras'
# parameters, the visibility law) stay the files'
TINY = {
    "rig-occl.solve": {"config": {"n_arc": 4, "n_ring": 8, "n_points": 400},
                       "traffic": {"occlusion_rings": 3,
                                   "visibility": 0.5}},
    "rig-occl.pipeline": {"config": {"n_arc": 4, "n_ring": 8,
                                     "n_points": 400},
                          "traffic": {"occlusion_rings": 3,
                                      "visibility": 0.5}},
    "bal-venice.solve": {"config": {"n_cameras": 40, "n_points": 600,
                                    "n_observations": 3000},
                         "traffic": {"window": 16, "track_clip": 40}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    """The card, or a skip with the reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")

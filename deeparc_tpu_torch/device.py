"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never a silent fall-back from one to the other."""

from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """The device to run on; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device (pass device='cpu' to run the plain "
                           "PyTorch versions of the kernels)")
    return device

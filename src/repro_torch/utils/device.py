"""The device rule of the port's public entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device a public entry point runs on: CUDA unless the caller
    names another. With no device named and no CUDA device this raises;
    it never moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)

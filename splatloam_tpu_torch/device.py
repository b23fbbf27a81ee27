"""Device selection shared by the port's entry points.

Every entry point runs on the GPU unless the caller asks for the CPU; it
never falls back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); else ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)

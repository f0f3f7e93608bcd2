"""Device choice of the port's entry points.

Every entry point runs on ``cuda`` unless its caller asks for another
device.  Without a CUDA device the default raises: the port never falls
back to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev

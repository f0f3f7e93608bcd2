"""Gradient clipping — the port of ``repro.optim.clip``."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.params import leaves

F32 = torch.float32


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf²), in f32, on the leaves'
    device (a 0-d tensor: no host sync)."""
    sq = None
    for _, g in leaves(tree):
        s = torch.sum(g.to(F32) ** 2)
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float) -> Tuple[object, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / (norm + 1e-9)) in f32 and cast
    back, in place.  Returns (tree, norm)."""
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for _, g in leaves(tree):
        g.copy_((g.to(F32) * scale).to(g.dtype))
    return tree, gn

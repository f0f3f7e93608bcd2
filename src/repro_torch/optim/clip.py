"""Gradient clipping — the port of ``repro.optim.clip``.

On a mesh whose "model" axis shards some leaves, a rank holds only its
piece of each sharded gradient: the squares of those pieces are summed,
the sum is all-reduced over the "model" group and added to the squares of
the replicated leaves (counted once, as every rank of the group holds the
same), and only then is the norm taken and the clip applied.  With
nothing sharded the norm is the single-device one, term for term.
"""
from __future__ import annotations

from typing import Collection, Optional, Tuple

import torch

from repro_torch.models.params import leaves
from repro_torch.sharding import all_reduce_sum_

F32 = torch.float32


def global_norm(tree, *, sharded: Collection[Tuple[str, ...]] = (),
                group=None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf²), in f32, on the leaves'
    device (a 0-d tensor: no host sync).  ``sharded``: the key paths of
    the leaves that are pieces of a leaf sharded over ``group``."""
    sq = sh = None
    for path, g in leaves(tree):
        s = torch.sum(g.to(F32) ** 2)
        if path in sharded:
            sh = s if sh is None else sh + s
        else:
            sq = s if sq is None else sq + s
    if sh is not None:
        all_reduce_sum_(sh, group)
        sq = sh if sq is None else sq + sh
    return torch.sqrt(sq)


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float, *,
                        sharded: Collection[Tuple[str, ...]] = (),
                        group: Optional[object] = None
                        ) -> Tuple[object, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / (norm + 1e-9)) in f32 and cast
    back, in place.  Returns (tree, norm)."""
    gn = global_norm(tree, sharded=sharded, group=group)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for _, g in leaves(tree):
        g.copy_((g.to(F32) * scale).to(g.dtype))
    return tree, gn

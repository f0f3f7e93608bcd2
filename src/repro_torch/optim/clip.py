"""Gradient clipping — the port of ``repro.optim.clip``.

On a mesh that shards some leaves, a rank holds only its piece of each
sharded gradient: the squares of the pieces spread over the same groups
are summed, the sum is all-reduced over each of those groups in turn
("model", then "data" for a leaf sharded over both) and added to the
squares of the replicated leaves (counted once, as every rank holds the
same), and only then is the norm taken and the clip applied, so every
element counts once across the world.  With nothing sharded the norm is
the single-device one, term for term.
"""
from __future__ import annotations

from typing import Collection, Mapping, Optional, Tuple, Union

import torch

from repro_torch.models.params import leaves
from repro_torch.sharding import all_reduce_sum_

F32 = torch.float32


Sharded = Union[Collection[Tuple[str, ...]], Mapping[Tuple[str, ...], Tuple]]


def global_norm(tree, *, sharded: Sharded = (), group=None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf²), in f32, on the leaves'
    device (a 0-d tensor: no host sync).  ``sharded``: the key paths of
    the leaves that are pieces of a leaf sharded over ``group``, or a map
    from such a path to the groups its pieces are spread over
    (``sharding.mesh_grads``)."""
    if not isinstance(sharded, Mapping):
        sharded = {path: (group,) for path in sharded}
    sq = None
    parts: dict = {}
    for path, g in leaves(tree):
        s = torch.sum(g.to(F32) ** 2)
        groups = sharded.get(path)
        if groups:
            parts[groups] = s if groups not in parts else parts[groups] + s
        else:
            sq = s if sq is None else sq + s
    for groups, sh in parts.items():
        for grp in groups:
            all_reduce_sum_(sh, grp)
        sq = sh if sq is None else sq + sh
    return torch.sqrt(sq)


@torch.no_grad()
def clip_by_global_norm(tree, max_norm: float, *, sharded: Sharded = (),
                        group: Optional[object] = None
                        ) -> Tuple[object, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / (norm + 1e-9)) in f32 and cast
    back, in place.  Returns (tree, norm)."""
    gn = global_norm(tree, sharded=sharded, group=group)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for _, g in leaves(tree):
        g.copy_((g.to(F32) * scale).to(g.dtype))
    return tree, gn

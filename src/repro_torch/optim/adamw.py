"""AdamW over parameter trees — the port of ``repro.optim.adamw``.

Memory policy, as the reference's: moments in f32 whatever the parameter
dtype (bf16 params, f32 state), the update computed in f32 and cast back to
the parameter dtype.  ``torch.optim.AdamW`` is not used: it keeps the
moments in the parameter dtype.

Unlike the reference, which returns new trees, ``adamw_update`` updates the
parameters and both moments in place (one leaf at a time, so the f32
temporaries never exceed one leaf) and returns the same objects: at full
width a second copy of the state would not fit beside the first.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.config import OptimConfig
from repro_torch.models.params import leaves

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the host
    mu: Dict            # first moments (f32, same tree as params)
    nu: Dict            # second moments (f32)


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=F32, device=tree.device)


def adamw_init(params) -> AdamWState:
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=_zeros_like_tree(params),
                      nu=_zeros_like_tree(params))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: OptimConfig,
                 lr: float) -> Tuple[Dict, AdamWState]:
    """One AdamW step.  ``grads`` is a tree like ``params`` (any dtype);
    ``lr`` the step's learning rate.  Returns ``(params, state)``, both
    updated in place."""
    b1, b2 = cfg.betas
    step = int(state.step) + 1
    # bias corrections in f32, as the reference computes 1 - b ** step
    c1 = torch.tensor(1.0, dtype=F32) - torch.tensor(b1, dtype=F32) ** step
    c2 = torch.tensor(1.0, dtype=F32) - torch.tensor(b2, dtype=F32) ** step
    lr = torch.tensor(lr, dtype=F32)
    g_leaves = dict(leaves(grads))
    m_leaves = dict(leaves(state.mu))
    v_leaves = dict(leaves(state.nu))
    for path, p in leaves(params):
        g, m, v = g_leaves[path], m_leaves[path], v_leaves[path]
        dev = p.device
        gf = g.to(F32)
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(gf * (1 - b2) * gf)
        delta = (m / c1.to(dev)) / (torch.sqrt(v / c2.to(dev)) + cfg.eps)
        if cfg.weight_decay:
            delta.add_(cfg.weight_decay * p.to(F32))
        p.copy_((p.to(F32) - lr.to(dev) * delta).to(p.dtype))
    state.step.fill_(step)
    return params, state

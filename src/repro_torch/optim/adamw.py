"""AdamW over parameter trees — the port of ``repro.optim.adamw``.

Memory policy, as the reference's: moments in f32 whatever the parameter
dtype (bf16 params, f32 state), the update computed in f32 and cast back to
the parameter dtype.  ``torch.optim.AdamW`` is not used: it keeps the
moments in the parameter dtype.

Unlike the reference, which returns new trees, the update writes the
parameters and both moments in place, a leaf at a time and a large leaf a
flat chunk of at most ``CHUNK`` elements at a time, so the f32
temporaries never exceed one chunk: at full width a second copy of the
state would not fit beside the first, and a stacked leaf's f32 temporaries
alone would take several GiB (``zamba2-2.7b``'s in_proj, 1.44 B values, is
5.4 GiB in f32).  The update is elementwise, so chunking changes no bit.

The step counter stays on the host (``AdamWState.step``, what checkpoints
save).  A step's learning rate and bias corrections are host values too,
computed once per step and written into three device scalars
(:class:`StepScalars`, by fills: no host-to-device copy), which
``adamw_apply`` reads; so the device work of a step never waits on the
host and can be captured into a CUDA graph, whose replays read the
scalars written before each replay.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.config import OptimConfig
from repro_torch.models.params import leaves

F32 = torch.float32
# elements of the largest slice updated at once (256 MiB of f32)
CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the host
    mu: Dict            # first moments (f32, same tree as params)
    nu: Dict            # second moments (f32)


class StepScalars(NamedTuple):
    """One step's learning rate and bias corrections, f32 0-d tensors on
    the parameters' device."""
    lr: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=F32, device=tree.device)


def adamw_init(params) -> AdamWState:
    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=_zeros_like_tree(params),
                      nu=_zeros_like_tree(params))


def bias_corrections(cfg: OptimConfig, step: int) -> Tuple[float, float]:
    """(1 - b1 ** step, 1 - b2 ** step), each computed in f32 as the
    reference computes it, as Python floats (exact f32 values)."""
    b1, b2 = cfg.betas
    one = torch.tensor(1.0, dtype=F32)
    return (float(one - torch.tensor(b1, dtype=F32) ** step),
            float(one - torch.tensor(b2, dtype=F32) ** step))


def step_scalars(device) -> StepScalars:
    return StepScalars(*(torch.zeros((), dtype=F32, device=device)
                         for _ in range(3)))


def write_step_scalars(scalars: StepScalars, cfg: OptimConfig, step: int,
                       lr: float) -> None:
    """Write step ``step``'s (1-based) learning rate and bias corrections
    into ``scalars``, enqueued behind the device work already in flight."""
    for t, v in zip(scalars, (lr, *bias_corrections(cfg, step))):
        t.fill_(v)


@torch.no_grad()
def adamw_apply(params, grads, state: AdamWState, cfg: OptimConfig,
                scalars: StepScalars) -> None:
    """The device half of one AdamW step: moments and params updated in
    place from ``scalars``; reads and writes no host value (the caller
    advances ``state.step``)."""
    g_leaves = dict(leaves(grads))
    m_leaves = dict(leaves(state.mu))
    v_leaves = dict(leaves(state.nu))
    for path, p in leaves(params):
        g, m, v = g_leaves[path], m_leaves[path], v_leaves[path]
        if p.dim() == 0 or p.numel() <= CHUNK:
            _adamw_slice(p, g, m, v, cfg, scalars)
            continue
        # flat chunks of the contiguous leaf and moments (a stack of one
        # layer, such as a full-width MoE expert table of 1.26 B values,
        # has no leading dim to cut)
        flat = [t.view(-1) for t in (p, m, v)] + [g.reshape(-1)]
        for i in range(0, p.numel(), CHUNK):
            pc, mc, vc, gc = (t[i:i + CHUNK] for t in flat)
            _adamw_slice(pc, gc, mc, vc, cfg, scalars)


def _adamw_slice(p, g, m, v, cfg: OptimConfig,
                 scalars: StepScalars) -> None:
    """AdamW on one leaf or flat chunk of one, in place."""
    b1, b2 = cfg.betas
    gf = g.to(F32)
    m.mul_(b1).add_(gf * (1 - b1))
    v.mul_(b2).add_(gf * (1 - b2) * gf)
    delta = (m / scalars.c1) / (torch.sqrt(v / scalars.c2) + cfg.eps)
    if cfg.weight_decay:
        delta.add_(cfg.weight_decay * p.to(F32))
    p.copy_((p.to(F32) - scalars.lr * delta).to(p.dtype))


def adamw_update(params, grads, state: AdamWState, cfg: OptimConfig,
                 lr: float) -> Tuple[Dict, AdamWState]:
    """One AdamW step.  ``grads`` is a tree like ``params`` (any dtype);
    ``lr`` the step's learning rate.  Returns ``(params, state)``, both
    updated in place, and the host step counter advanced.  The reference's
    whole-step API, kept as the parity tests' entry: the trainers write
    the scalars once per step and call ``adamw_apply``."""
    step = int(state.step) + 1
    _, first = next(leaves(params))
    scalars = step_scalars(first.device)
    write_step_scalars(scalars, cfg, step, lr)
    adamw_apply(params, grads, state, cfg, scalars)
    state.step.fill_(step)
    return params, state

"""Gradient-accumulation microbatching — the port of
``repro.distributed.microbatch``.

A batch that does not fit the device is split on its batch axis into
``k`` sequential chunks; each chunk's gradients are accumulated in f32
and the sum is divided by ``k``, so the optimizer sees the full batch's
mean gradient up to f32 summation order (every loss is a mean over the
batch and the chunks are equal).  Only one chunk's activations are live
at a time.  The loss and the aux metrics are the mean of the per-chunk
values, as the reference's; a non-linear diagnostic (``adv_std``,
``logp_gap``) is then the mean of per-chunk values.  Losses with a
batch-global statistic (GRPO-Guard's RatioNorm) are refused at trainer
construction (``BaseTrainer.microbatch_safe``).

Each chunk's loss draws from its own generator (the caller seeds chunk
``c``'s with ``fold_seed(seed, c)``, the reference's ``fold_in(key,
idx)``), so the NFT/AWM timestep and noise draws are independent per
chunk.  The port's losses run their own backward passes, so
:func:`accumulated_value_and_grad` takes the trainer's loss and leaves the
averaged gradients in the parameters' ``.grad``, where the trainer reads
them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.rollout import Trajectory
from repro_torch.models.params import leaves

F32 = torch.float32


def chunk_batch(x: torch.Tensor, axis: int, k: int) -> torch.Tensor:
    """Split dim ``axis`` (size B) into k chunks, the chunk axis first."""
    s = tuple(x.shape)
    x = x.reshape(s[:axis] + (k, s[axis] // k) + s[axis + 1:])
    return x.movedim(axis, 0)


def chunk_trajectory(traj: Trajectory, k: int) -> List[Trajectory]:
    """The k chunks of a trajectory, as views (batch on axis 1 of ``xs``
    and ``logps``, axis 0 of ``cond``; the time grid and mask shared)."""
    xs, lp, cond = (chunk_batch(traj.xs, 1, k), chunk_batch(traj.logps, 1, k),
                    chunk_batch(traj.cond, 0, k))
    return [Trajectory(xs=xs[c], logps=lp[c], ts=traj.ts,
                       sde_mask=traj.sde_mask, cond=cond[c])
            for c in range(k)]


def accumulated_value_and_grad(
        loss_fn: Callable, params, traj: Trajectory, adv: torch.Tensor,
        generators: Sequence[Optional[torch.Generator]], k: int, *,
        t: Optional[Sequence[Optional[torch.Tensor]]] = None,
        eps: Optional[Sequence[Optional[torch.Tensor]]] = None
        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, aux) of ``loss_fn`` averaged over ``k`` sequential chunks of
    the batch, with the chunks' gradients summed in f32, divided by ``k``
    and left in each leaf's ``.grad`` (in the leaf's dtype).

    ``loss_fn(params, traj, adv, generator, t=, eps=)`` runs its own
    backward (``BaseTrainer.loss_fn``); ``params``' leaves require grad.
    ``generators[c]``, ``t[c]`` and ``eps[c]`` go to chunk ``c``.  The
    caller validates ``B % k == 0``."""
    chunks = chunk_trajectory(traj, k)
    adv_c = chunk_batch(adv, 0, k)
    ps = [p for _, p in leaves(params)]
    acc = [torch.zeros(p.shape, dtype=F32, device=p.device) for p in ps]
    loss_sum = None
    aux_sum: Dict[str, torch.Tensor] = {}
    for c in range(k):
        for p in ps:
            p.grad = None
        loss, aux = loss_fn(params, chunks[c], adv_c[c], generators[c],
                            t=None if t is None else t[c],
                            eps=None if eps is None else eps[c])
        for a, p in zip(acc, ps):
            if p.grad is not None:
                a.add_(p.grad.to(F32))
        loss_sum = loss.detach().to(F32) if loss_sum is None \
            else loss_sum + loss.detach().to(F32)
        for name, v in aux.items():
            v = v.detach().to(F32)
            aux_sum[name] = v if name not in aux_sum else aux_sum[name] + v
    for i, p in enumerate(ps):
        p.grad = acc[i].div_(k).to(p.dtype)
        acc[i] = None                    # one f32 leaf at a time, not all
    return loss_sum / k, {name: v / k for name, v in aux_sum.items()}

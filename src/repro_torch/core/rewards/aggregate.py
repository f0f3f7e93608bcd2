"""Advantage aggregation strategies (paper §2.3) — the port of
``repro.core.rewards.aggregate``.

Given per-reward raw scores {name: (B,)} for grouped samples (B = P·G with
G consecutive samples per prompt), produce per-sample advantages (B,):

* ``weighted_sum`` — A = groupnorm(Σᵢ wᵢ·rᵢ)
* ``gdpo`` — A = Σᵢ wᵢ·groupnorm(rᵢ) (per-reward decoupled normalization)
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import registry

F32 = torch.float32


def group_normalize(r: torch.Tensor, group_size: int, eps: float = 1e-6
                    ) -> torch.Tensor:
    """(B,) -> (B,): subtract the group mean, divide by the group's
    population std (+ eps), as the reference's ``jnp.std``."""
    B = r.shape[0]
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    if B % group_size != 0:
        raise ValueError(
            f"batch size {B} is not divisible by group_size {group_size}: "
            "GRPO group statistics need whole groups")
    g = r.to(F32).reshape(B // group_size, group_size)
    mu = g.mean(dim=1, keepdim=True)
    sd = g.std(dim=1, keepdim=True, correction=0)
    return ((g - mu) / (sd + eps)).reshape(B)


@registry.register("aggregator", "weighted_sum")
def weighted_sum(rewards: Dict[str, torch.Tensor], weights: Dict[str, float],
                 group_size: int) -> torch.Tensor:
    total = sum(weights[k] * rewards[k].to(F32) for k in rewards)
    return group_normalize(total, group_size)


@registry.register("aggregator", "gdpo")
def gdpo(rewards: Dict[str, torch.Tensor], weights: Dict[str, float],
         group_size: int) -> torch.Tensor:
    return sum(weights[k] * group_normalize(rewards[k], group_size)
               for k in rewards)


def compute_advantages(strategy: str, rewards: Dict[str, torch.Tensor],
                       weights: Dict[str, float], group_size: int
                       ) -> torch.Tensor:
    return registry.build("aggregator", strategy, rewards, weights,
                          group_size)

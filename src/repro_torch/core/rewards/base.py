"""Reward-model interfaces (paper §2.3) — the port of
``repro.core.rewards.base``.

* :class:`PointwiseRewardModel` — ``score(x) → R`` per sample.
* :class:`GroupwiseRewardModel` — ``rank(x₁..x_k) → R^k`` relative scores
  within a GRPO group.

Every model declares ``model_id``, the identity of its frozen network; the
loader deduplicates on it.  ``load_params(generator)`` builds a model's
frozen parameters on ``generator``'s device, and ``set_params`` replaces
them (the tests carry the JAX package's towers across with it).
"""
from __future__ import annotations

from typing import Any, Dict

import torch


class BaseRewardModel:
    """Common base. ``x0`` is the final latent (B, Lt, ld); ``cond_meta``
    carries condition embeddings."""

    kind: str = "pointwise"

    def __init__(self, model_id: str = ""):
        self.model_id = model_id or type(self).__name__

    def load_params(self, generator: torch.Generator) -> Any:
        """The frozen scorer's parameters, on ``generator``'s device (called
        once per unique model_id by the loader)."""
        return None

    def set_params(self, params: Any) -> None:
        self.params = params


class PointwiseRewardModel(BaseRewardModel):
    kind = "pointwise"

    def score(self, x0: torch.Tensor, cond_meta: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
        """x0: (B, Lt, ld) -> rewards (B,)."""
        raise NotImplementedError


class GroupwiseRewardModel(BaseRewardModel):
    kind = "groupwise"

    def rank(self, x0_groups: torch.Tensor,
             cond_meta: Dict[str, torch.Tensor]) -> torch.Tensor:
        """x0_groups: (P, G, Lt, ld) -> relative scores (P, G)."""
        raise NotImplementedError

    def score(self, x0: torch.Tensor, cond_meta: Dict[str, torch.Tensor], *,
              group_size: int) -> torch.Tensor:
        """Reshape (P·G, ...) into groups, rank, flatten back to (P·G,)."""
        B = x0.shape[0]
        P = B // group_size
        groups = x0.reshape((P, group_size) + tuple(x0.shape[1:]))
        return self.rank(groups, cond_meta).reshape(B)

"""Concrete reward models — the port of ``repro.core.rewards.models``.

The reference reproduces the paper's PickScore and text-rendering rewards as
frozen synthetic scorers with the same interface and cost profile:

* ``pickscore`` — frozen 3-layer MLP preference scorer over (pooled latent,
  pooled condition).
* ``text_render`` — cosine similarity of the latent to a prompt-derived
  target pattern (a frozen projection of the pooled condition).
* ``latent_norm`` — −(‖x₀‖_rms − 1)², keeping latents on-distribution.
* ``pref_group`` — groupwise soft win-rate under the pickscore scorer.

Each scorer draws its frozen weights from its own ``seed`` (a
``torch.Generator`` on the loader's device), as the reference draws them from
``jax.random.PRNGKey(seed)``; the two packages' draws differ, so the tests
carry the reference's weights across with ``set_params``.  Scores are
computed in f32.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import registry
from repro_torch.core.rewards.base import (GroupwiseRewardModel,
                                           PointwiseRewardModel)

F32 = torch.float32


def _pool(x0: torch.Tensor) -> torch.Tensor:
    return x0.to(F32).mean(dim=1)                    # (B, ld)


def _draw(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=F32,
                       device=gen.device).div_(math.sqrt(fan_in))


@registry.register("reward", "pickscore")
class PickScoreStub(PointwiseRewardModel):
    """Frozen MLP preference scorer (PickScore, Kirstain et al., 2023)."""

    def __init__(self, model_id: str = "pickscore-base", latent_dim: int = 16,
                 cond_dim: int = 512, hidden: int = 256, seed: int = 7):
        super().__init__(model_id)
        self.latent_dim, self.cond_dim = latent_dim, cond_dim
        self.hidden, self.seed = hidden, seed

    def load_params(self, generator: torch.Generator) -> Any:
        gen = torch.Generator(device=generator.device).manual_seed(self.seed)
        d_in = self.latent_dim + self.cond_dim
        return {"w1": _draw(gen, (d_in, self.hidden), d_in),
                "w2": _draw(gen, (self.hidden, self.hidden), self.hidden),
                "w3": _draw(gen, (self.hidden, 1), self.hidden)}

    def score(self, x0, cond_meta):
        pooled_c = cond_meta["cond"].to(F32).mean(dim=1)   # (B, cond_dim)
        h = torch.cat([_pool(x0), pooled_c], dim=-1)
        p = self.params
        h = torch.tanh(h @ p["w1"])
        h = torch.tanh(h @ p["w2"])
        return (h @ p["w3"])[:, 0]


@registry.register("reward", "text_render")
class TextRenderReward(PointwiseRewardModel):
    """Prompt-conditioned target-pattern similarity (text-rendering proxy):
    the target is a frozen projection of the pooled condition into latent
    space, and the reward is the cosine similarity to it.  At FLUX.1-dev's
    geometry the projection is 4096 × 262,144 f32 (4.3 GB)."""

    def __init__(self, model_id: str = "text-render", latent_dim: int = 16,
                 latent_tokens: int = 64, cond_dim: int = 512, seed: int = 11):
        super().__init__(model_id)
        self.latent_dim, self.latent_tokens = latent_dim, latent_tokens
        self.cond_dim, self.seed = cond_dim, seed

    def load_params(self, generator: torch.Generator) -> Any:
        gen = torch.Generator(device=generator.device).manual_seed(self.seed)
        return {"proj": _draw(
            gen, (self.cond_dim, self.latent_tokens * self.latent_dim),
            self.cond_dim)}

    def score(self, x0, cond_meta):
        B = x0.shape[0]
        pooled_c = cond_meta["cond"].to(F32).mean(dim=1)
        target = (pooled_c @ self.params["proj"]).reshape(x0.shape)
        a = x0.to(F32).reshape(B, -1)
        b = target.reshape(B, -1)
        return torch.sum(a * b, -1) / (
            torch.linalg.norm(a, dim=-1) * torch.linalg.norm(b, dim=-1)
            + 1e-8)


@registry.register("reward", "latent_norm")
class LatentNormPenalty(PointwiseRewardModel):
    """−(‖x₀‖_rms − 1)²: keeps latents on the unit-variance manifold the VAE
    decoder expects."""

    def __init__(self, model_id: str = "latent-norm"):
        super().__init__(model_id)

    def score(self, x0, cond_meta):
        rms = torch.sqrt((x0.to(F32) ** 2).mean(dim=(1, 2)))
        return -(rms - 1.0) ** 2


@registry.register("reward", "pref_group")
class PrefGroupReward(GroupwiseRewardModel):
    """Pairwise-preference groupwise reward (Pref-GRPO): the reward of
    sample i is its soft win-rate against the rest of its group under the
    frozen pickscore scorer (shared by ``model_id``, so the loader loads one
    tower for both)."""

    def __init__(self, model_id: str = "pickscore-base", latent_dim: int = 16,
                 cond_dim: int = 512, hidden: int = 256, seed: int = 7,
                 temperature: float = 10.0):
        super().__init__(model_id)
        self._scorer = PickScoreStub(model_id, latent_dim, cond_dim, hidden,
                                     seed)
        self.temperature = temperature

    def load_params(self, generator: torch.Generator) -> Any:
        return self._scorer.load_params(generator)

    def set_params(self, params: Any) -> None:
        self.params = params
        self._scorer.set_params(params)

    def rank(self, x0_groups, cond_meta):
        P, G = x0_groups.shape[:2]
        flat = x0_groups.reshape((P * G,) + tuple(x0_groups.shape[2:]))
        s = self._scorer.score(flat, cond_meta).reshape(P, G)
        diff = s[:, :, None] - s[:, None, :]                  # (P, G, G)
        win = torch.sigmoid(self.temperature * diff)
        mask = 1.0 - torch.eye(G, dtype=F32, device=s.device)[None]
        return (win * mask).sum(-1) / max(G - 1, 1)

"""GRPO-Guard (Wang et al., 2025a) — mitigates the *negatively-biased ratio
distribution* of flow-SDE formulations (the port of
``repro.core.trainers.grpo_guard``).

The SDE transition variance is timestep-dependent, so the importance ratio
ρ = exp(logp_new − logp_old) is systematically biased low at high-noise
timesteps; naive clipping then asymmetrically suppresses positive updates.
GRPO-Guard applies **RatioNorm** — recentring each timestep's ratio
distribution by its batch mean (detached) — plus the standard regulated
clip, so every timestep contributes an unbiased, comparable gradient.

The reference sends only vanilla GRPO to its fused loss kernel
(``repro/core/trainers/grpo.py:37-38``), so this trainer's loss takes the
plain PyTorch branch of ``FlowGRPOTrainer.loss_fn``.  RatioNorm is a
statistic of one timestep's batch, which the port's one backward per
timestep holds whole; on a data mesh its mean is all-reduced over the
"data" ranks (``BaseTrainer.batch_mean``).
"""
from __future__ import annotations

import torch

from repro_torch import registry
from repro_torch.core.trainers.grpo import FlowGRPOTrainer


@registry.register("trainer", "grpo_guard")
class GRPOGuardTrainer(FlowGRPOTrainer):
    rollout_sde = True
    # RatioNorm is a batch-global statistic: microbatched chunks would each
    # recentre by their own chunk mean, silently weakening the correction
    microbatch_safe = False

    def ratio_transform(self, ratio: torch.Tensor, t_index: int,
                        is_sde: bool) -> torch.Tensor:
        # RatioNorm: divide by the batch-mean ratio at this timestep; the
        # mean is detached: the correction is a statistic, not a policy term
        # (on a data mesh the whole batch's mean, over every rank's rows)
        mean = self.batch_mean(ratio.detach().mean())
        return ratio / torch.clamp(mean, min=1e-6)

"""MixGRPO (Li et al., 2025) — *Flow-GRPO-Fast*: SDE on only a small window
of timesteps (1–2 by default), ODE everywhere else (the port of
``repro.core.trainers.mix_grpo``).  Cuts both the sampling noise-injection
cost and the training cost: the policy gradient needs the velocity only at
the SDE steps, and the loss (``FlowGRPOTrainer.loss_fn``) runs only those,
through the ``grpo_loss`` kernel.  The window can slide over training
(``sde_window_shift_every``) so all timesteps eventually receive gradient
signal.
"""
from __future__ import annotations

import torch

from repro_torch import registry
from repro_torch.core.rollout import mix_sde_mask
from repro_torch.core.trainers.grpo import FlowGRPOTrainer


@registry.register("trainer", "mix_grpo")
class MixGRPOTrainer(FlowGRPOTrainer):
    rollout_sde = True

    def sde_mask(self, it: int) -> torch.Tensor:
        shift = 0
        if self.flow.sde_window_shift_every:
            shift = it // self.flow.sde_window_shift_every
        return mix_sde_mask(self.flow.num_steps, self.flow.sde_window, shift)

"""Advantage Weighted Matching (Xue et al., 2025a) — aligns RL with the
pretraining objective by weighting the standard velocity-matching loss with
per-sample advantages (paper Eq. 3; the port of
``repro.core.trainers.awm``):

    L = E[ A(x₀) · ‖v_θ(x_t, t) − (ε − x₀)‖² ]

Solver-agnostic: trajectories come from an ODE solver; the loss touches
only the forward process, with one velocity forward over the batch and its
backward.  Advantages are clipped to a bounded range for stability
(negative advantages *increase* velocity error on bad samples, which is the
policy-gradient-aligned direction but diverges if unbounded).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import registry
from repro_torch.core.rollout import Trajectory
from repro_torch.core.trainers.base import BaseTrainer

F32 = torch.float32


@registry.register("trainer", "awm")
class AWMTrainer(BaseTrainer):
    rollout_sde = False           # ODE rollouts

    adv_clip: float = 3.0

    def loss_fn(self, params, traj: Trajectory, adv: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                t: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The advantage-weighted velocity error at drawn (or given)
        timesteps ``t`` and noise ``eps``, and its backward.  Returns the
        loss and aux metrics (``vel_err``, ``adv_clip_frac``) as detached
        device scalars."""
        x0 = traj.x0
        cond = traj.cond
        t, eps = self.forward_draws(generator, x0, t, eps)
        tt = t[:, None, None]
        x_t = (1.0 - tt) * x0 + tt * eps
        target = eps - x0

        v = self.velocity(params, x_t, t, cond)
        se = ((v - target) ** 2).mean(dim=(1, 2))            # (B,)
        adv = adv.detach().to(F32)
        a = torch.clamp(adv, -self.adv_clip, self.adv_clip)
        loss = (a * se).mean()
        loss.backward()
        aux = {"vel_err": torch.sqrt(self.batch_mean(se.detach().mean())),
               "adv_clip_frac": self.batch_mean(
                   (adv.abs() > self.adv_clip).to(F32).mean())}
        return loss.detach(), aux

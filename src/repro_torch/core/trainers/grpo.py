"""Flow-GRPO trainer (Liu et al., 2025) — PPO-style clipped policy gradient
over SDE transition log-probabilities, with group-relative advantages (the
port of ``repro.core.trainers.grpo``)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import registry
from repro_torch.core.rollout import Trajectory
from repro_torch.core.trainers.base import BaseTrainer
from repro_torch.kernels import ops

F32 = torch.float32


@registry.register("trainer", "flow_grpo")
class FlowGRPOTrainer(BaseTrainer):
    rollout_sde = True

    def ratio_transform(self, ratio: torch.Tensor, t_index: int,
                        is_sde: bool) -> torch.Tensor:
        """Hook for GRPO-Guard's RatioNorm; identity here.
        ratio: (B,) at one timestep."""
        return ratio

    def loss_fn(self, params, traj: Trajectory, adv: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The GRPO loss, mean over the SDE timesteps of each step's mean
        PPO-clip loss, and its gradient.

        The T timesteps run as a Python loop, and each SDE step's term
        ``step_loss.mean() / n_sde`` is back-propagated at once, so only one
        timestep's activations are live at a time (at FLUX.1-dev's 4608
        tokens this is what lets one card hold the step).  The gradients
        accumulate in the parameters' ``.grad`` in the parameter dtype, as
        the reference's scan transpose accumulates them; the result equals
        its single ``value_and_grad`` up to f32 summation order.  ``n_sde``
        is known on the host from the trajectory's mask, and ODE steps,
        whose loss the reference masks to zero, are skipped.

        The velocity runs through the same code and kernels as in the
        rollout (the attention kernel's forward gives bitwise the same
        output with its LSE as without), so the ratio differs from 1 only
        by the two log-density formulas.  ``logp_new`` is the scheduler's
        plain-PyTorch ``logprob``; the vanilla-GRPO step loss (no KL, no
        ratio transform: the reference's kernel condition) is the fused
        ``grpo_loss`` kernel with its closed-form backward.  Returns the
        loss and aux metrics as detached device scalars; ``logp_gap`` is
        max |logp_new - logp_old| over the SDE steps."""
        T = self.flow.num_steps
        clip = self.flow.clip_range
        cond = traj.cond
        B = cond.shape[0]
        use_kernel = (type(self).ratio_transform
                      is FlowGRPOTrainer.ratio_transform
                      and self.flow.kl_coef == 0.0)
        mask = [bool(m) for m in traj.sde_mask]
        denom = max(sum(mask), 1)
        ts = [float(t) for t in traj.ts]
        adv = adv.detach().to(F32)
        zero = torch.zeros((), dtype=F32, device=cond.device)
        loss_sum, clip_sum, gap = zero, zero, zero
        for i in range(T):
            if not mask[i]:
                continue
            t, t_next = ts[i], ts[i + 1]
            x_t, x_next = traj.xs[i], traj.xs[i + 1]
            tb = torch.full((B,), t, dtype=F32, device=cond.device)
            v = self.velocity(params, x_t, tb, cond)
            logp_new = self.scheduler.logprob(v, x_t, t, t_next, x_next)
            logp_old = traj.logps[i]
            if use_kernel:
                step_loss, frac = ops.grpo_loss_trainable(
                    logp_new, logp_old, adv, clip=clip)
            else:
                ratio = torch.exp(torch.clamp(logp_new - logp_old, -20.0,
                                              20.0))
                ratio = self.ratio_transform(ratio, i, True)
                unclipped = ratio * adv
                clipped = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
                step_loss = -torch.minimum(unclipped, clipped)
                # KL penalty against the behaviour policy (optional)
                step_loss = step_loss + self.flow.kl_coef * 0.5 * (
                    logp_new - logp_old) ** 2
                frac = (torch.abs(ratio - 1.0) > clip).to(F32)
            term = step_loss.mean()
            (term / denom).backward()
            loss_sum = loss_sum + term.detach()
            clip_sum = clip_sum + frac.detach().mean()
            gap = torch.maximum(gap, (logp_new.detach() - logp_old).abs().max())
        aux = {"clip_frac": clip_sum / denom,
               "adv_std": adv.std(correction=0), "logp_gap": gap}
        return loss_sum / denom, aux

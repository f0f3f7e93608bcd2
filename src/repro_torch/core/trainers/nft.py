"""DiffusionNFT (Zheng et al., 2025) — online RL on the *forward* process
(the port of ``repro.core.trainers.nft``).

No likelihoods, no SDE sampling: trajectories come from an ODE solver, and
training contrasts an implicit positive and negative policy on the forward
flow-matching objective (paper Eq. 2):

    L = E[ r·‖v⁺_θ(x_t,c,t) − v‖² + (1−r)·‖v⁻_θ(x_t,c,t) − v‖² ]

with v = ε − x₀ the forward-process velocity target and r = sigmoid(A) ∈
[0, 1] from the group-normalized advantages.  The implicit negative is the
reflection about a reference policy, v⁻ = 2·v_ref − v_θ.

The reference policy is the *behavior* policy, the params that sampled
the current round.  The reference threads ``self.state.params`` into its
update as that policy, and since its update runs at those same params,
``v_ref`` equals ``v_θ`` there.  In the port the parameters are updated in
place, so holding ``self.state.params`` as "the reference" would alias the
live leaves; instead the step path takes ``v_ref = v_θ.detach()``, which
is exact (the same forward) and saves a full-width forward.  A caller that
passes a distinct ``ref_params`` (the reference's direct-call path) gets a
second forward under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import registry
from repro_torch.core.rollout import Trajectory
from repro_torch.core.trainers.base import BaseTrainer

F32 = torch.float32


@registry.register("trainer", "nft")
class DiffusionNFTTrainer(BaseTrainer):
    rollout_sde = False           # ODE rollouts (Table 1 row "ODE")

    def loss_fn(self, params, traj: Trajectory, adv: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                t: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None, ref_params=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One velocity forward with grad over the batch at drawn (or
        given) timesteps ``t`` and noise ``eps``, and its backward.
        ``ref_params`` None means the reference policy is ``params``
        themselves (the step path).  Returns the loss and aux metrics
        (``r_mean``, ``vel_err``) as detached device scalars."""
        x0 = traj.x0
        cond = traj.cond
        t, eps = self.forward_draws(generator, x0, t, eps)
        tt = t[:, None, None]
        x_t = (1.0 - tt) * x0 + tt * eps
        target = eps - x0

        v_pos = self.velocity(params, x_t, t, cond)
        if ref_params is None:
            v_ref = v_pos.detach()
        else:
            with torch.no_grad():
                v_ref = self.velocity(ref_params, x_t, t, cond)
        v_neg = 2.0 * v_ref - v_pos

        r = torch.sigmoid(adv.detach().to(F32))[:, None, None]
        se_pos = (v_pos - target) ** 2
        se_neg = (v_neg - target) ** 2
        loss = (r * se_pos + (1.0 - r) * se_neg).mean()
        loss.backward()
        aux = {"r_mean": self.batch_mean(r.mean()),
               "vel_err": torch.sqrt(self.batch_mean(se_pos.detach().mean()))}
        return loss.detach(), aux

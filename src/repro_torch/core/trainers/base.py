"""BaseTrainer — the paper's algorithm-logic component type (the port of
``repro.core.trainers.base``).

Owns sampling (``rollout``), reward computation (``MultiRewardLoader``),
advantage aggregation and the optimization step.  Subclasses implement
``loss_fn``.  The port runs on one device (``device``, default ``cuda``);
other layouts and perf policies raise ``NotImplementedError``.

The parameters stay the nested dict of tensors that ``models.params``
builds.  ``_update`` marks the leaves ``requires_grad``, lets ``loss_fn``
run its backward passes (gradients accumulate in the leaves' ``.grad``, in
the parameter dtype), clips them by their global norm, applies AdamW in
place and clears them again, so sampling never sees a leaf that requires
grad.

Randomness: parameters are drawn from a generator seeded with ``seed`` (as
the serving path draws them), the reward towers from their own seeds, and
step ``it`` of ``step(cond, seed, it)`` samples from a generator seeded with
``fold_seed(seed, it)`` and draws the update's randomness (the timesteps
and forward-process noise of the NFT/AWM losses) from one seeded with
``fold_seed(fold_seed(seed, it), 1)``, so a resumed run replays an
uninterrupted one.  ``step`` also takes the rollout's ``x_init`` / ``eps``
and the update's ``update_t`` / ``update_eps`` to replay injected draws.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import optim, registry
from repro_torch.config import (ArchConfig, DistConfig, FlowRLConfig,
                                OptimConfig, PerfConfig, RewardSpec,
                                check_ported_layout)
from repro_torch.core import schedulers
from repro_torch.core.rewards import MultiRewardLoader, compute_advantages
from repro_torch.core.rollout import (Trajectory, fold_seed, group_repeat,
                                      rollout)
from repro_torch.device import resolve_device
from repro_torch.models import params as params_lib
from repro_torch.models.flow import FlowAdapter

F32 = torch.float32

# default reward is shape-agnostic (works for any latent geometry)
DEFAULT_REWARDS = (RewardSpec(reward_type="latent_norm", weight=1.0),)


class RLState(NamedTuple):
    params: Dict
    opt: optim.AdamWState


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


class BaseTrainer:
    """Subclass contract: implement ``loss_fn(params, traj, adv, generator,
    t=None, eps=None)``, which runs the backward pass(es) itself and
    returns (loss, aux metrics).  ``generator`` draws the loss's own
    randomness; ``t`` / ``eps`` replace those draws when given."""

    #: GRPO variants sample with an SDE; NFT/AWM force ODE sampling
    rollout_sde: bool = True

    #: losses that compute batch-global statistics (GRPO-Guard's RatioNorm
    #: mean) set this False: gradient-accumulation microbatching would make
    #: them chunk-local (the reference refuses such trainers there)
    microbatch_safe: bool = True

    def __init__(self, arch_cfg: ArchConfig, flow_cfg: FlowRLConfig,
                 opt_cfg: OptimConfig, *, seed: int = 0,
                 cond_dim: int = 512, dtype=torch.bfloat16, device=None,
                 dist: Optional[DistConfig] = None,
                 perf: Optional[PerfConfig] = None, params=None):
        if flow_cfg.group_size < 1:
            raise ValueError(
                f"flow.group_size must be >= 1, got {flow_cfg.group_size}")
        check_ported_layout(dist or DistConfig(), perf or PerfConfig())
        self.device = resolve_device(device)
        self.cfg = arch_cfg
        self.flow = flow_cfg
        self.opt_cfg = opt_cfg
        self.adapter = FlowAdapter(arch_cfg, flow_cfg, cond_dim)
        if not self.rollout_sde:
            self.sde_mode = "all_ode"
        elif type(self).sde_mask is BaseTrainer.sde_mask:
            self.sde_mode = "all_sde"
        else:
            self.sde_mode = "mixed"
        sde_type = flow_cfg.sde_type if self.rollout_sde else "ode"
        self.scheduler = schedulers.build(sde_type, flow_cfg.eta)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = params_lib.init(self.adapter.spec(), gen, dtype,
                                     self.device)
        self.optimizer = registry.build("optimizer", opt_cfg.optimizer)
        self.state = RLState(params, self.optimizer.init(params))
        specs = flow_cfg.rewards or DEFAULT_REWARDS
        self.loader = MultiRewardLoader(specs, fold_seed(seed, 1),
                                        self.device)
        self._lr = optim.make_schedule(opt_cfg)

    # ------------------------------------------------------------- sampling
    def sde_mask(self, it: int):
        return None  # default: all steps stochastic (or all ODE)

    def sample(self, params, cond: torch.Tensor,
               generator: Optional[torch.Generator], it: int = 0, *,
               x_init: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None) -> Trajectory:
        """cond: (P, Lc, D) prompt embeddings -> grouped trajectories
        (P·G samples)."""
        cond_g = group_repeat(cond, self.flow.group_size)
        return rollout(self.adapter, params, cond_g, generator,
                       self.scheduler, self.flow.num_steps,
                       self.sde_mask(it), sde_mode=self.sde_mode,
                       x_init=x_init, eps=eps)

    # -------------------------------------------------------------- rewards
    def _rewards(self, x0: torch.Tensor, cond_meta: Dict
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                            Dict[str, torch.Tensor]]:
        """(raw rewards, advantages, reward stats); the stats (the weighted
        ``reward_mean`` the optimizer ascends and the per-reward means) are
        device scalars."""
        G = self.flow.group_size
        rew = self.loader.compute_all(x0, cond_meta, group_size=G)
        weights = self.loader.weight_map()
        adv = compute_advantages(self.flow.advantage_agg, rew, weights, G)
        stats = {f"reward/{name}": r.to(F32).mean()
                 for name, r in rew.items()}
        stats["reward_mean"] = sum(weights[name] * stats[f"reward/{name}"]
                                   for name in rew)
        return rew, adv, stats

    # --------------------------------------------------------------- update
    def loss_fn(self, params, traj: Trajectory, adv: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                t: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def velocity(self, params, x, t, cond):
        return self.adapter.velocity(params, x, t, cond)

    def sample_timesteps(self, generator: Optional[torch.Generator],
                         batch: int, *, draw: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Timestep sampling strategies of the solver-agnostic algorithms
        (paper §3.2), as the reference's ``sample_timesteps``: ``uniform``
        on [0.02, 0.98], ``logit_normal`` (the sigmoid of a standard
        normal) and ``discrete`` (a uniform pick of the rollout's grid
        ``scheduler.timesteps(T)[:-1]``).  Each strategy transforms one base
        variate per sample, drawn from ``generator``: a uniform on [0, 1),
        a standard normal and an integer index respectively.  ``draw``
        replaces it (tests replay the JAX package's variates through it).
        Returns (batch,) float32 on the generator's device."""
        how = self.flow.timestep_sampling
        dev = generator.device if draw is None else draw.device
        if how == "uniform":
            u = draw if draw is not None else torch.rand(
                (batch,), generator=generator, dtype=F32, device=dev)
            lo, hi = torch.tensor([0.02, 0.98], dtype=F32, device=dev)
            return torch.maximum(lo, u.to(F32) * (hi - lo) + lo)
        if how == "logit_normal":
            z = draw if draw is not None else torch.randn(
                (batch,), generator=generator, dtype=F32, device=dev)
            return torch.sigmoid(z.to(F32))
        if how == "discrete":
            grid = torch.from_numpy(
                self.scheduler.timesteps(self.flow.num_steps)[:-1]).to(dev)
            idx = draw if draw is not None else torch.randint(
                0, grid.shape[0], (batch,), generator=generator, device=dev)
            return grid[idx.long()]
        raise ValueError(f"unknown timestep_sampling {how!r}")

    def forward_draws(self, generator: Optional[torch.Generator],
                      x0: torch.Tensor, t: Optional[torch.Tensor] = None,
                      eps: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The draws of a forward-process loss (NFT, AWM): per-sample
        timesteps t (B,) from ``sample_timesteps``, then the noise eps of
        x0's shape, both f32 from ``generator`` in that order (the
        reference's ``k_t, k_eps = split(key)``), unless given."""
        if t is None:
            t = self.sample_timesteps(generator, x0.shape[0])
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, dtype=F32,
                              device=x0.device)
        return (t.to(device=x0.device, dtype=F32),
                eps.to(device=x0.device, dtype=F32))

    def backward(self, traj: Trajectory, adv: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 t: Optional[torch.Tensor] = None,
                 eps: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run ``loss_fn`` with the parameter leaves requiring grad; their
        gradients are left in ``.grad`` (zeros for leaves the loss does not
        reach, as JAX returns them).  ``generator``, ``t`` and ``eps`` go to
        the loss's own draws.  Returns (loss, aux)."""
        leaves = [p for _, p in params_lib.leaves(self.state.params)]
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        try:
            loss, aux = self.loss_fn(self.state.params, traj, adv, generator,
                                     t=t, eps=eps)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return loss, aux

    def apply_grads(self) -> Tuple[torch.Tensor, float]:
        """Clip the leaves' ``.grad`` by their global norm, take one
        optimizer step in place and clear the gradients.  Returns
        (grad norm before clipping, learning rate)."""
        params = self.state.params
        grads = _map(params, lambda p: p.grad)
        _, gnorm = optim.clip_by_global_norm(grads, self.opt_cfg.grad_clip)
        lr = self._lr(int(self.state.opt.step))
        self.optimizer.update(params, grads, self.state.opt, self.opt_cfg,
                              lr)
        for _, p in params_lib.leaves(params):
            p.grad = None
        return gnorm, lr

    def _update(self, traj: Trajectory, adv: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                t: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        loss, aux = self.backward(traj, adv, generator, t=t, eps=eps)
        gnorm, lr = self.apply_grads()
        metrics = dict(aux)
        metrics.update(loss=loss, grad_norm=gnorm,
                       lr=torch.tensor(lr, dtype=F32, device=loss.device))
        return metrics

    # ------------------------------------------------------------ iteration
    def step(self, cond: torch.Tensor, seed: int, it: int = 0, *,
             x_init: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None,
             update_t: Optional[torch.Tensor] = None,
             update_eps: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One full RL iteration: rollout -> rewards -> advantages -> update.

        cond: (P, Lc, cond_dim) prompt embeddings on the trainer's device
        (from the preprocessing cache or a live encoder).  ``x_init`` /
        ``eps`` replace the rollout's draws, ``update_t`` / ``update_eps``
        the update's (the forward-process losses' timesteps and noise).
        Returns a flat dict of device scalars (loss, grad_norm, lr, the
        trainer's aux metrics, reward_mean and the per-reward means);
        callers fetch them with one host transfer."""
        step_seed = fold_seed(seed, it)
        gen = torch.Generator(device=self.device).manual_seed(step_seed)
        traj = self.sample(self.state.params, cond, gen, it, x_init=x_init,
                           eps=eps)
        _, adv, reward_stats = self._rewards(traj.x0, {"cond": traj.cond})
        gen_u = torch.Generator(device=self.device).manual_seed(
            fold_seed(step_seed, 1))
        metrics = self._update(traj, adv, gen_u, t=update_t, eps=update_eps)
        metrics.update(reward_stats)
        return metrics

"""Trajectory sampling for RL fine-tuning and serving — the port of
``repro.core.rollout``.

``rollout`` is the trainer's batch rollout: one ``torch.Generator`` draws the
init latent of the whole (group-repeated) batch and then every step's noise,
in the full-SDE (Flow-GRPO), mixed ODE/SDE (MixGRPO) or pure-ODE (NFT/AWM)
mode.  ``rollout_keyed`` is the serving engine's: each request carries one
integer seed whose generator draws its init latent and its
``(num_steps, Lt, ld)`` step noise, so a request's latent is a function of
its own (cond, seed, num_steps) alone, whatever batch or bucket it runs in.
Both take the init latent and the noise as tensors instead when given, so
tests replay the JAX package's draws.  The denoising loop is a Python loop
over steps; the time grid stays on the host and each step receives
``t``/``t_next`` as Python floats.  Sampling never builds an autograd graph.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.schedulers import SDESchedulerMixin
from repro_torch.models.flow import FlowAdapter

F32 = torch.float32
_MASK64 = (1 << 64) - 1


class Trajectory(NamedTuple):
    xs: torch.Tensor        # (T+1, B, Lt, ld)  states (xs[0] = noise)
    logps: torch.Tensor     # (T, B)            transition log-probs (0 on ODE steps)
    ts: torch.Tensor        # (T+1,)            descending time grid (host)
    sde_mask: torch.Tensor  # (T,) bool         which steps were stochastic (host)
    cond: torch.Tensor      # (B, Lc, cond_dim) condition embeddings

    @property
    def x0(self) -> torch.Tensor:
        return self.xs[-1]


def fold_seed(seed: int, i: int) -> int:
    """The seed of sub-stream ``i`` of ``seed`` (a splitmix64 mix; the
    port's ``jax.random.fold_in``)."""
    z = (seed * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def request_seeds(seed: int, batch: int) -> List[int]:
    """Per-request seeds: row i = fold_seed(seed, i).  Request i's latent
    depends on row i alone, never on who else shares the batch."""
    return [fold_seed(seed, i) for i in range(batch)]


def request_draws(adapter: FlowAdapter, seed: int, num_steps: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One request's (x_init (Lt, ld), eps (num_steps, Lt, ld)), both drawn
    in that order from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x_init = adapter.init_latent(gen, 1, device)[0]
    fc = adapter.flow_cfg
    eps = torch.randn((num_steps, fc.latent_tokens, fc.latent_dim),
                      generator=gen, dtype=F32, device=device)
    return x_init, eps


SDE_MODES = ("mixed", "all_sde", "all_ode")


def _mask_list(sde_mask, num_steps: int) -> List[bool]:
    mask = ([True] * num_steps if sde_mask is None
            else [bool(m) for m in sde_mask])
    if len(mask) != num_steps:
        raise ValueError(f"sde_mask has {len(mask)} entries for "
                         f"{num_steps} steps")
    return mask


@torch.no_grad()
def rollout(adapter: FlowAdapter, params, cond: torch.Tensor,
            generator: Optional[torch.Generator],
            scheduler: SDESchedulerMixin, num_steps: int,
            sde_mask: Optional[Sequence[bool]] = None, *,
            sde_mode: str = "mixed", x_init: Optional[torch.Tensor] = None,
            eps: Optional[torch.Tensor] = None) -> Trajectory:
    """cond: (B, Lc, cond_dim), already group-repeated by the caller, on the
    device the rollout runs on.

    ``generator`` (on that device) draws the init latent ``(B, Lt, ld)``
    and then the step noise ``(T, B, Lt, ld)``, in that order, unless
    ``x_init`` / ``eps`` are given.  ``sde_mode`` mirrors the reference's
    specializations, with the same values: ``"all_sde"`` steps every
    timestep through ``step_with_eps``; ``"all_ode"`` through ``step_ode``
    with zero log-prob and no noise drawn; ``"mixed"`` picks per step by
    the host booleans of ``sde_mask``.  The trajectory carries
    ``sde_mask`` as given (all True by default), as the reference's
    does."""
    if sde_mode not in SDE_MODES:
        raise ValueError(f"sde_mode must be one of {SDE_MODES}, "
                         f"got {sde_mode!r}")
    B = cond.shape[0]
    device = cond.device
    ts = scheduler.timesteps(num_steps)
    mask = _mask_list(sde_mask, num_steps)
    stoch = {"all_sde": [True] * num_steps, "all_ode": [False] * num_steps,
             "mixed": mask}[sde_mode]
    if x_init is None:
        x_init = adapter.init_latent(generator, B, device)
    if eps is None and any(stoch):
        fc = adapter.flow_cfg
        eps = torch.randn((num_steps, B, fc.latent_tokens, fc.latent_dim),
                          generator=generator, dtype=F32, device=device)
    x = x_init.to(device=device, dtype=F32)
    xs, logps = [x], []
    for i in range(num_steps):
        t, t_next = float(ts[i]), float(ts[i + 1])
        tb = torch.full((B,), t, dtype=F32, device=device)
        v = adapter.velocity(params, x, tb, cond).to(F32)
        if stoch[i]:
            x, logp = scheduler.step_with_eps(v, x, t, t_next,
                                              eps[i].to(device=device,
                                                        dtype=F32))
        else:
            x = scheduler.step_ode(v, x, t, t_next)
            logp = torch.zeros((B,), dtype=F32, device=device)
        xs.append(x)
        logps.append(logp)
    return Trajectory(xs=torch.stack(xs), logps=torch.stack(logps),
                      ts=torch.from_numpy(ts),
                      sde_mask=torch.tensor(mask, dtype=torch.bool),
                      cond=cond)


@torch.no_grad()
def rollout_keyed(adapter: FlowAdapter, params, cond: torch.Tensor,
                  seeds: Sequence[int], scheduler: SDESchedulerMixin,
                  num_steps: int, sde_mask: Optional[Sequence[bool]] = None,
                  *, x_init: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None) -> Trajectory:
    """cond: (B, Lc, cond_dim) on the device the rollout runs on; ``seeds``:
    B integers, one per request.  ``x_init`` (B, Lt, ld) and ``eps``
    (T, B, Lt, ld) replace the seeded draws when given (tests replay the
    JAX package's draws through them).  ``sde_mask`` (host booleans, default
    all True) sends masked steps through ``step_ode`` with zero log-prob."""
    B = cond.shape[0]
    if len(seeds) != B:
        raise ValueError(
            f"rollout_keyed: {B} cond rows but {len(seeds)} seeds — every "
            "request needs exactly one seed")
    device = cond.device
    ts = scheduler.timesteps(num_steps)
    mask = _mask_list(sde_mask, num_steps)
    if x_init is None or eps is None:
        draws = [request_draws(adapter, s, num_steps, device) for s in seeds]
        if x_init is None:
            x_init = torch.stack([d[0] for d in draws])
        if eps is None:
            eps = torch.stack([d[1] for d in draws], dim=1)
    x = x_init.to(device=device, dtype=F32)
    eps = eps.to(device=device, dtype=F32)
    xs, logps = [x], []
    for i in range(num_steps):
        t, t_next = float(ts[i]), float(ts[i + 1])
        tb = torch.full((B,), t, dtype=F32, device=device)
        v = adapter.velocity(params, x, tb, cond).to(F32)
        if mask[i]:
            x, logp = scheduler.step_with_eps(v, x, t, t_next, eps[i])
        else:
            x = scheduler.step_ode(v, x, t, t_next)
            logp = torch.zeros((B,), dtype=F32, device=device)
        xs.append(x)
        logps.append(logp)
    return Trajectory(xs=torch.stack(xs), logps=torch.stack(logps),
                      ts=torch.from_numpy(ts),
                      sde_mask=torch.tensor(mask, dtype=torch.bool),
                      cond=cond)


def group_repeat(cond: torch.Tensor, group_size: int) -> torch.Tensor:
    """(P, Lc, D) prompts -> (P·G, Lc, D) with each prompt repeated G times
    (consecutive — group g of prompt p occupies rows p·G..p·G+G−1)."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    return torch.repeat_interleave(cond, group_size, dim=0)


def mix_sde_mask(num_steps: int, window: int, shift: int = 0
                 ) -> torch.Tensor:
    """MixGRPO: SDE on a sliding window of timesteps, ODE elsewhere
    ((num_steps,) bool on the host)."""
    idx = (torch.arange(num_steps) - shift) % num_steps
    return idx < window

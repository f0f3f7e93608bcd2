"""Per-request-seeded trajectory sampling — the port of
``repro.core.rollout.rollout_keyed`` (the serving engine's rollout).

Each request carries one integer seed.  Its ``torch.Generator`` draws the
request's init latent (through ``adapter.init_latent``) and then its
``(num_steps, Lt, ld)`` step noise, so a request's latent is a function of
its own (cond, seed, num_steps) alone, whatever batch or bucket it runs in.
The denoising loop is a Python loop over steps; the time grid stays on the
host and each step receives ``t``/``t_next`` as Python floats.
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
    mask = ([True] * num_steps if sde_mask is None
            else [bool(m) for m in sde_mask])
    if len(mask) != num_steps:
        raise ValueError(f"sde_mask has {len(mask)} entries for "
                         f"{num_steps} steps")
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

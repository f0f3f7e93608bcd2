"""SDE schedulers (paper Table 1) behind a unified ``SDESchedulerMixin`` —
the port of ``repro.core.schedulers``.

Rectified-flow convention: ``x_t = (1-t)·x₀ + t·ε``; sampling integrates t
from 1 (noise) down to 0.  With ``Δ = t - t_next > 0`` a step is

    x_next = x_t − [v + (σ_t²/2t)(x_t + (1−t)·v)]·Δ + σ_t·√Δ·ε

a Gaussian transition whose log-probability is closed form.

  flow_sde   σ_t = η·√(t/(1−t))          (Flow-GRPO; fused sde_step kernel)
  dance_sde  σ_t = η                      (DanceGRPO)
  cps        coefficient-preserving noise  (FlowCPS)
  ode        σ_t = 0                      (deterministic; NFT/AWM)

The time grid is an f32 numpy array known on the host; the rollout hands
``t``/``t_next`` to the steps as Python floats, so no step reads the device.
Scalar coefficients are computed as f32 0-d tensors, as the reference
computes them in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch import registry

F32 = torch.float32
_EPS = 1e-4
LOG2PI = math.log(2.0 * math.pi)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=F32, device=like.device)


def _sum_dims(x: torch.Tensor) -> torch.Tensor:
    """Sum over all but the leading (batch) axis."""
    return x.reshape(x.shape[0], -1).sum(dim=-1)


def gaussian_logpdf(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor
                    ) -> torch.Tensor:
    """Per-sample (batch,) log N(x; mean, std²·I), summed over event dims."""
    z = (x.to(F32) - mean.to(F32)) / std
    return _sum_dims(-0.5 * (z * z + LOG2PI) - torch.log(std)
                     * torch.ones_like(z))


class SDESchedulerMixin:
    """Unified stochastic-sampling interface (paper §2.1 component type)."""

    eta: float

    def timesteps(self, num_steps: int) -> np.ndarray:
        """Descending f32 grid t_0=1-ε … t_T=ε, shape (num_steps+1,)."""
        return np.linspace(1.0 - _EPS, _EPS, num_steps + 1).astype(
            np.float32)

    # -- per-dynamics hooks (t, t_next: f32 0-d tensors) --------------------
    def sigma(self, t: torch.Tensor, t_next: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def mean_next(self, v, x, t, t_next) -> torch.Tensor:
        """Deterministic part of the transition (paper Eq. 1 drift)."""
        delta = t - t_next
        sig = self.sigma(t, t_next)
        drift = v + (sig ** 2 / (2.0 * t)) * (x + (1.0 - t) * v)
        return x - drift * delta

    def noise_std(self, t, t_next) -> torch.Tensor:
        return self.sigma(t, t_next) * torch.sqrt(t - t_next)

    # -- unified API ---------------------------------------------------------
    def step_with_eps(self, v: torch.Tensor, x: torch.Tensor, t, t_next,
                      eps: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One sampling step from supplied noise ``eps``.  Returns
        (x_next f32, logp (batch,) f32).  Subclasses with a fused kernel
        override this hook."""
        xf, vf = x.to(F32), v.to(F32)
        t, t_next = _f32(t, xf), _f32(t_next, xf)
        mean = self.mean_next(vf, xf, t, t_next)
        std = self.noise_std(t, t_next)
        stochastic = std > 0
        x_next = torch.where(stochastic, mean + std * eps.to(F32), mean)
        safe_std = torch.clamp_min(std, 1e-20)
        logp = torch.where(stochastic,
                           gaussian_logpdf(x_next, mean, safe_std),
                           torch.zeros(x.shape[0], dtype=F32,
                                       device=x.device))
        return x_next, logp

    def step(self, v: torch.Tensor, x: torch.Tensor, t, t_next,
             generator: torch.Generator
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One sampling step with noise drawn from ``generator`` (on x's
        device).  Returns (x_next, logp (batch,))."""
        eps = torch.randn(x.shape, generator=generator, dtype=F32,
                          device=x.device)
        return self.step_with_eps(v, x, t, t_next, eps)

    def logprob(self, v: torch.Tensor, x: torch.Tensor, t, t_next,
                x_next: torch.Tensor) -> torch.Tensor:
        """log p(x_next | x; v), differentiable in ``v`` — recomputed under
        the current params for the GRPO importance ratio."""
        xf, vf = x.to(F32), v.to(F32)
        t, t_next = _f32(t, xf), _f32(t_next, xf)
        mean = self.mean_next(vf, xf, t, t_next)
        std = torch.clamp_min(self.noise_std(t, t_next), 1e-20)
        return gaussian_logpdf(x_next, mean, std)

    def step_ode(self, v: torch.Tensor, x: torch.Tensor, t: float,
                 t_next: float) -> torch.Tensor:
        """Deterministic flow update (MixGRPO's ODE segments).  The step
        size is a host scalar: the difference of two f32 grid points,
        rounded once to f32 as the reference's f32 subtraction is."""
        return x.to(F32) - v.to(F32) * (float(t) - float(t_next))


@registry.register("scheduler", "flow_sde")
@dataclasses.dataclass
class FlowSDEScheduler(SDESchedulerMixin):
    """Flow-GRPO (Liu et al., 2025): σ_t = η·√(t/(1−t)), with the σ argument
    clamped at ``t_sigma_max``.  ``step_with_eps`` is the fused ``sde_step``
    kernel on CUDA tensors (its plain version on CPU tensors)."""
    eta: float = 0.7
    t_sigma_max: float = 0.96

    def sigma(self, t, t_next):
        tc = torch.clamp(t, _EPS, self.t_sigma_max)
        return self.eta * torch.sqrt(tc / (1.0 - tc))

    def step_with_eps(self, v, x, t, t_next, eps):
        from repro_torch.kernels import ops
        if self.t_sigma_max != 0.96:
            raise ValueError("the fused sde_step clamps σ's argument at "
                             f"0.96, not {self.t_sigma_max}")
        return ops.sde_step(v, x, eps, float(t), float(t_next), eta=self.eta)


@registry.register("scheduler", "dance_sde")
@dataclasses.dataclass
class DanceSDEScheduler(SDESchedulerMixin):
    """DanceGRPO (Xue et al., 2025b): σ_t = η (constant)."""
    eta: float = 0.3

    def sigma(self, t, t_next):
        return torch.full_like(t, self.eta)


@registry.register("scheduler", "cps")
@dataclasses.dataclass
class CPSScheduler(SDESchedulerMixin):
    """FlowCPS (Wang & Yu, 2025) — coefficients-preserving sampling: the
    noise component of the marginal is rotated rather than grown,

        x_next = (1−t')·x̂₀ + t'·(cos(ηπ/2)·ε̂ + sin(ηπ/2)·ε_fresh)

    with x̂₀ = x − t·v and ε̂ = (x_ode − (1−t')·x̂₀)/t'."""
    eta: float = 0.5

    def _trig(self, fn, like):
        return fn(_f32(self.eta * math.pi / 2.0, like))

    def sigma(self, t, t_next):
        delta = torch.clamp_min(t - t_next, 1e-20)
        return t_next * self._trig(torch.sin, t) / torch.sqrt(delta)

    def mean_next(self, v, x, t, t_next):
        c = self._trig(torch.cos, x)
        x0_hat = x - t * v
        x_ode = x - v * (t - t_next)
        eps_hat = (x_ode - (1.0 - t_next) * x0_hat) / torch.clamp_min(
            t_next, _EPS)
        return (1.0 - t_next) * x0_hat + t_next * c * eps_hat

    def noise_std(self, t, t_next):
        return t_next * self._trig(torch.sin, t)


@registry.register("scheduler", "ode")
@dataclasses.dataclass
class ODEScheduler(SDESchedulerMixin):
    """Deterministic sampling (σ=0) — for DiffusionNFT / AWM (paper §3.2)."""
    eta: float = 0.0

    def sigma(self, t, t_next):
        return torch.zeros_like(t)


def build(sde_type: str, eta: float) -> SDESchedulerMixin:
    return registry.build("scheduler", sde_type, eta=eta)

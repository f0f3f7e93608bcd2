"""Plain PyTorch versions of the hand-written kernels: the functions the
kernel wrappers compute, written with tensor ops.  ``kernels/ops.py`` routes
CPU tensors here; the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

import math
from typing import Tuple

import torch

F32 = torch.float32
NEG_INF = -1e30
LOG2PI = math.log(2.0 * math.pi)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k/v: (B,Sk,K,D/Dv) -> (B,Sq,H,Dv), softmax in f32."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, D).to(F32)
    s = torch.einsum("bskgd,btkd->bskgt", qg, k.to(F32)) * (D ** -0.5)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= kp > qp - window
    s = torch.where(ok[None, :, None, None, :], s,
                    torch.tensor(NEG_INF, dtype=F32, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", p, v.to(F32))
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def sde_step_ref(v: torch.Tensor, x: torch.Tensor, t, t_next,
                 eps: torch.Tensor, *, eta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flow-SDE Euler–Maruyama step + Gaussian log-prob (paper Eq. 1).

    v, x, eps: (B, ...); t, t_next: scalars.  Returns (x_next, logp (B,)),
    both float32."""
    dev = x.device
    t = torch.as_tensor(t, dtype=F32, device=dev)
    t_next = torch.as_tensor(t_next, dtype=F32, device=dev)
    xf, vf = x.to(F32), v.to(F32)
    # σ argument clamped (FlowSDEScheduler.t_sigma_max); drift uses raw t
    tc = torch.clamp(t, 1e-4, 0.96)
    sigma = eta * torch.sqrt(tc / (1.0 - tc))
    delta = t - t_next
    drift = vf + (sigma ** 2 / (2.0 * t)) * (xf + (1.0 - t) * vf)
    mean = xf - drift * delta
    std = sigma * torch.sqrt(delta)
    x_next = mean + std * eps.to(F32)
    z = (x_next - mean) / std
    logp = -0.5 * (z * z + LOG2PI) - torch.log(std)
    return x_next, logp.reshape(x.shape[0], -1).sum(-1)

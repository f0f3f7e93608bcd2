"""Plain PyTorch versions of the hand-written kernels: the functions the
kernel wrappers compute, written with tensor ops.  ``kernels/ops.py`` routes
CPU tensors here; the tests hold them against the JAX package's oracles, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

F32 = torch.float32
NEG_INF = -1e30
LOG2PI = math.log(2.0 * math.pi)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: int
            ) -> torch.Tensor:
    """Masked, scaled scores (B, Sq, K, G, Sk) in f32 (GQA groups split)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, D).to(F32)
    s = torch.einsum("bskgd,btkd->bskgt", qg, k.to(F32)) * (D ** -0.5)
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= kp > qp - window
    return torch.where(ok[None, :, None, None, :], s,
                       torch.tensor(NEG_INF, dtype=F32, device=q.device))


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): ``flash_attention_ref``'s output, bitwise, and each row's
    log-sum-exp of the masked, scaled scores, f32 (B, H, Sq) — the
    statistic the backward recomputes the probabilities from."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", p, v.to(F32))
    lse = torch.logsumexp(s, dim=-1).reshape(B, Sq, H).transpose(1, 2)
    return (o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype),
            lse.contiguous())


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D); k/v: (B,Sk,K,D/Dv) -> (B,Sq,H,Dv), softmax in f32."""
    return flash_attention_fwd_ref(q, k, v, causal=causal, window=window)[0]


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, do: torch.Tensor, *,
                            causal: bool = True, window: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_ref`` at upstream gradient ``do``,
    written out from the forward's ``lse`` (B, H, Sq), in f32 and cast to
    the inputs' dtypes:

        P = exp(S - lse),  dV = P^T dO,  dP = dO V^T,
        D_i = sum_d dO_i O_i,  dS = P (dP - D),
        dQ = scale dS K,  dK = scale dS^T Q

    with dK and dV summed over the query heads of each GQA group.  ``o`` is
    the forward's output as the caller kept it (rounded to its dtype), as
    the kernel's delta pass reads it."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = D ** -0.5
    s = _scores(q, k, causal, window)
    lse_g = lse.transpose(1, 2).reshape(B, Sq, K, G, 1)
    p = torch.exp(s - lse_g)
    del s
    dog = do.reshape(B, Sq, K, G, -1).to(F32)
    dv = torch.einsum("bskgt,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bskgt", dog, v.to(F32))
    delta = (dog * o.reshape(B, Sq, K, G, -1).to(F32)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    del p, dp
    qg = q.reshape(B, Sq, K, G, D).to(F32)
    dq = torch.einsum("bskgt,btkd->bskgd", ds, k.to(F32)) * scale
    dk = torch.einsum("bskgt,bskgd->btkd", ds, qg) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def grpo_loss_ref(logp_new: torch.Tensor, logp_old: torch.Tensor,
                  adv: torch.Tensor, *, clip: float, guard: bool = False,
                  ratio_mean: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """PPO-clip objective per sample (optionally GRPO-Guard RatioNorm).

    logp_new/logp_old/adv: (B,).  Under ``guard`` the ratio is divided by
    max(``ratio_mean``, 1e-6), where ``ratio_mean`` defaults to the
    batch's own mean ratio (not differentiated).  Returns (per-sample loss,
    clip fraction), f32."""
    ratio = torch.exp(torch.clamp(logp_new - logp_old, -20.0, 20.0))
    if guard:
        mean = (ratio.detach().mean() if ratio_mean is None
                else torch.as_tensor(ratio_mean, dtype=F32,
                                     device=ratio.device).reshape(()))
        ratio = ratio / torch.clamp_min(mean, 1e-6)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
    loss = -torch.minimum(unclipped, clipped)
    frac = (torch.abs(ratio - 1.0) > clip).to(F32)
    return loss, frac


def grpo_loss_bwd_ref(logp_new: torch.Tensor, logp_old: torch.Tensor,
                      adv: torch.Tensor, g: torch.Tensor, *, clip: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form VJP of the unguarded ``grpo_loss_ref`` at upstream
    gradient ``g`` (the reference's ``_gld_bwd``): (d_logp_new, d_logp_old,
    d_adv).  The log-ratio is active when the unclipped branch is the min,
    or when the ratio lies inside the clip band."""
    ratio = torch.exp(torch.clamp(logp_new - logp_old, -20.0, 20.0))
    a = adv.to(F32)
    unclipped = ratio * a
    rc = torch.clamp(ratio, 1.0 - clip, 1.0 + clip)
    clipped = rc * a
    in_band = torch.abs(ratio - 1.0) <= clip
    unclipped_min = unclipped <= clipped
    active = unclipped_min | in_band
    gf = g.to(F32)
    d_lpn = -a * ratio * active.to(F32) * gf
    d_adv = -torch.where(unclipped_min, ratio, rc) * gf
    return d_lpn, -d_lpn, d_adv

"""Kernel dispatch layer.

The model, scheduler and trainer code call these wrappers.  The route
depends on where the tensors lie, and on nothing else: a CPU tensor goes to
the plain PyTorch version (``kernels/ref.py``), a CUDA tensor to the
hand-written kernel, which raises if it cannot build, if the card is not
sm_90, or if the launch fails.  There is no fallback from a CUDA tensor to
the plain version and no switch to force one.  Where gradients flow
(attention or the SSD scan with an input that requires grad, the trainer's
GRPO loss) the call goes through an autograd Function whose backward routes
the same way.  A ``meta`` tensor (the dry run, ``launch/dryrun.py``) goes to
the hand-written kernel's wrapper too, which allocates the card route's
buffers and launches nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import counts  # noqa: F401  (REPRO_KERNEL_COUNTS)
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.grpo_loss import GRPOLossFn
from repro_torch.kernels.grpo_loss import grpo_loss as _grpo
from repro_torch.kernels.sde_step import sde_step as _sde
from repro_torch.kernels.ssd_scan import SSDScanFn
from repro_torch.kernels.ssd_scan import ssd_scan as _ssd


def flash_attention(q, k, v, *, causal=True, window=0):
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash(q, k, v, causal=causal, window=window)


def sde_step(v, x, eps, t, t_next, *, eta=0.7):
    if x.device.type == "cpu":
        return ref.sde_step_ref(v, x, t, t_next, eps, eta=eta)
    return _sde(v, x, eps, t, t_next, eta=eta)


def ssd_scan(x, dt, a, bm, cm, *, chunk=128):
    """Mamba-2 SSD chunked scan from a zero state: (y (B,L,H,P) in x's
    dtype, final state (B,H,P,N) f32).  With grad enabled and any input
    requiring grad the call goes through ``SSDScanFn`` (the hand-written
    backward on the card, the plain closed form on the CPU); otherwise it
    routes by device."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, bm, cm)):
        return SSDScanFn.apply(x, dt, a, bm, cm, chunk)
    if x.device.type == "cpu":
        return ref.ssd_chunked_ref(x, dt, a, bm, cm, chunk)
    return _ssd(x, dt, a, bm, cm, chunk=chunk)


def grpo_loss(logp_new, logp_old, adv, ratio_mean=None, *, clip=0.2,
              guard=False):
    """(per-sample loss, clip fraction), not differentiated."""
    if logp_new.device.type == "cpu":
        return ref.grpo_loss_ref(logp_new, logp_old, adv, clip=clip,
                                 guard=guard, ratio_mean=ratio_mean)
    return _grpo(logp_new, logp_old, adv, ratio_mean, clip=clip, guard=guard)


def grpo_loss_trainable(logp_new, logp_old, adv, *, clip=0.2):
    """Differentiable GRPO loss of the trainer: (loss (B,), clip fraction
    (B,)), the fused kernel forward with the closed-form PPO-clip backward
    (``GRPOLossFn``); the fraction is not differentiated."""
    return GRPOLossFn.apply(logp_new, logp_old, adv, clip)

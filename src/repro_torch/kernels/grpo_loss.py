"""CUDA wrappers of the fused GRPO loss (``csrc/grpo_loss.cu``) and its
autograd Function.

``grpo_loss`` (forward: per-sample PPO-clip loss and clip fraction) and
``grpo_loss_bwd`` (the closed-form VJP the reference writes in jnp,
``repro.kernels.grpo_loss._gld_bwd``) take CUDA tensors only; each counts
the calls that launched its kernel in ``.launches``.  ``GRPOLossFn`` is the
differentiable loss of the trainer: its forward and its backward each send
CPU tensors to the plain versions (``ref.grpo_loss_ref``,
``ref.grpo_loss_bwd_ref``) and CUDA tensors to the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.sde_step import require_sm90

F32 = torch.float32


def _fn(name: str, n_ptr: int, tail):
    fn = getattr(_build.load("grpo_loss"), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptr + tail + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, *arrays: torch.Tensor) -> int:
    require_sm90(arrays[0].device)
    B = arrays[0].shape[0] if arrays[0].dim() == 1 else -1
    for a in arrays:
        if a.dim() != 1 or a.shape[0] != B or a.dtype != F32:
            raise ValueError(f"{name}: every input must be (B,) float32, got "
                             f"{[(tuple(x.shape), x.dtype) for x in arrays]}")
        if a.device != arrays[0].device or not a.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous and on one "
                             "device")
    if B == 0:
        raise ValueError(f"{name}: empty batch")
    return B


def _bounds(clip: float) -> Tuple[float, float]:
    # 1 - clip and 1 + clip rounded once to f32, as the reference rounds them
    return float(1.0 - clip), float(1.0 + clip)


def grpo_loss(logp_new: torch.Tensor, logp_old: torch.Tensor,
              adv: torch.Tensor, ratio_mean: Optional[torch.Tensor] = None,
              *, clip: float = 0.2, guard: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss (B,), clip fraction (B,)), f32.  ``ratio_mean``, read only
    under ``guard``, is a (1,) or () f32 tensor on the same device."""
    B = _check("grpo_loss", logp_new, logp_old, adv)
    mean_ptr = None
    if guard and ratio_mean is not None:
        ratio_mean = ratio_mean.reshape(1)
        if ratio_mean.dtype != F32 or ratio_mean.device != logp_new.device:
            raise ValueError("grpo_loss: ratio_mean must be float32 on the "
                             "inputs' device")
        mean_ptr = ratio_mean.data_ptr()
    loss = torch.empty_like(logp_new)
    frac = torch.empty_like(logp_new)
    stream = torch.cuda.current_stream(logp_new.device).cuda_stream
    rc = _fn("grpo_loss_fwd", 6, [ctypes.c_int, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_int])(
        logp_new.data_ptr(), logp_old.data_ptr(), adv.data_ptr(), mean_ptr,
        loss.data_ptr(), frac.data_ptr(), B, float(clip), *_bounds(clip),
        int(bool(guard)), stream)
    if rc != 0:
        raise RuntimeError(f"grpo_loss kernel launch failed: CUDA error {rc}")
    grpo_loss.launches += 1
    return loss, frac


def grpo_loss_bwd(logp_new: torch.Tensor, logp_old: torch.Tensor,
                  adv: torch.Tensor, g: torch.Tensor, *, clip: float = 0.2
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(d_logp_new, d_logp_old, d_adv) of the unguarded loss at upstream
    gradient ``g``, each (B,) f32."""
    B = _check("grpo_loss_bwd", logp_new, logp_old, adv, g)
    outs = [torch.empty_like(logp_new) for _ in range(3)]
    stream = torch.cuda.current_stream(logp_new.device).cuda_stream
    rc = _fn("grpo_loss_bwd", 7, [ctypes.c_int, ctypes.c_float,
                                  ctypes.c_float, ctypes.c_float])(
        logp_new.data_ptr(), logp_old.data_ptr(), adv.data_ptr(),
        g.data_ptr(), *(o.data_ptr() for o in outs), B, float(clip),
        *_bounds(clip), stream)
    if rc != 0:
        raise RuntimeError(
            f"grpo_loss_bwd kernel launch failed: CUDA error {rc}")
    grpo_loss_bwd.launches += 1
    return outs[0], outs[1], outs[2]


grpo_loss.launches = 0
grpo_loss_bwd.launches = 0


class GRPOLossFn(torch.autograd.Function):
    """Differentiable unguarded GRPO loss: (loss, clip fraction) forward,
    the closed-form PPO-clip VJP backward; the fraction is not
    differentiated.  Both directions pick the plain version for CPU tensors
    and the kernel for CUDA tensors, by device alone."""

    @staticmethod
    def forward(ctx, logp_new, logp_old, adv, clip: float):
        args = [a.detach().to(F32).contiguous()
                for a in (logp_new, logp_old, adv)]
        if args[0].device.type == "cpu":
            loss, frac = ref.grpo_loss_ref(*args, clip=clip)
        else:
            loss, frac = grpo_loss(*args, clip=clip)
        ctx.save_for_backward(*args)
        ctx.clip = clip
        ctx.mark_non_differentiable(frac)
        return loss, frac

    @staticmethod
    def backward(ctx, g_loss, _g_frac):
        args = ctx.saved_tensors
        g = g_loss.to(F32).contiguous()
        if g.device.type == "cpu":
            d = ref.grpo_loss_bwd_ref(*args, g, clip=ctx.clip)
        else:
            d = grpo_loss_bwd(*args, g, clip=ctx.clip)
        return d[0], d[1], d[2], None

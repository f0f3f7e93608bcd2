"""Kernel dispatch layer.

The model and scheduler code call these wrappers.  The route depends on
where the tensors lie, and on nothing else: a CPU tensor goes to the plain
PyTorch version (``kernels/ref.py``), a CUDA tensor to the hand-written
kernel, which raises if it cannot build, if the card is not sm_90, or if the
launch fails.  There is no fallback from a CUDA tensor to the plain version
and no switch to force one.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.sde_step import sde_step as _sde


def flash_attention(q, k, v, *, causal=True, window=0):
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash(q, k, v, causal=causal, window=window)


def sde_step(v, x, eps, t, t_next, *, eta=0.7):
    if x.device.type == "cpu":
        return ref.sde_step_ref(v, x, t, t_next, eps, eta=eta)
    return _sde(v, x, eps, t, t_next, eta=eta)

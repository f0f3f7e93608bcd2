"""CUDA wrapper of the flash-attention forward (``csrc/flash_attention.cu``).

``flash_attention`` takes CUDA tensors only; ``kernels/ops.py`` sends CPU
tensors to the plain version in ``kernels/ref.py``.
``flash_attention.launches`` counts the calls that launched the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sde_step import require_sm90

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0, on one CUDA
    device, all float32 or all bfloat16, D in {32, 64, 128} and contiguous
    (other strides are free).  Sq and Sk are any lengths.  Returns
    (B, Sq, H, D) in q's dtype, contiguous."""
    require_sm90(q.device)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    if Bk != B or tuple(v.shape) != tuple(k.shape) or Dk != D:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if K < 1 or H % K:
        raise ValueError(f"flash_attention: {H} query heads over {K} kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of "
                        f"{list(DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v lie on different devices")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the head dim must be contiguous")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    if Sk == 0:
        raise ValueError("flash_attention: no keys")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3]]
    rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                DTYPES[q.dtype], B, Sq, Sk, H, K, D, *strides,
                int(bool(causal)), int(window), float(D ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0

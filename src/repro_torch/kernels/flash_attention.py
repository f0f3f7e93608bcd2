"""CUDA wrappers of the flash-attention forward (``csrc/flash_attention.cu``)
and backward (``csrc/flash_attention_bwd.cu``), and their autograd Function.

``flash_attention`` and ``flash_attention_bwd`` take CUDA tensors only;
``kernels/ops.py`` sends CPU tensors to the plain versions in
``kernels/ref.py``.  The value dim may differ from the query/key dim, as in
the TPU kernel: the (query/key, value) dims the kernels are built for are
``DIM_PAIRS``, every head dim of ``HEAD_DIMS`` with itself (80 is
zamba2-2.7b's shared attention, stored padded to 96 columns by the bf16
kernels) and (192, 128), DeepSeek-V2's latent attention; the scale is the
query/key dim's ``D ** -0.5``.  Each wrapper
counts the calls that launched its kernels in ``.launches``, the same
calls by variant in ``.variant_launches`` (``"wgmma"`` for the bf16
tensor-core kernels (TMA and ``wgmma``), ``"fma"`` for the f32 CUDA-core
ones, chosen by ``tensor_core_route`` from dtype and layout alone) and by
dim pair in ``.pair_launches`` (keyed ``"192x128"``).
``FlashAttentionFn`` is the differentiable attention: its forward keeps
q, k, v, o and the rows' log-sum-exp, and its backward runs
``flash_attention_bwd``; both pick the plain version for CPU tensors and the
kernel for CUDA tensors, by device alone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.sde_step import require_sm90

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)
DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)
# values per 16 bytes of f32: the backward's lse and delta row pitch
LSE_ROW_ALIGN = 4


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def tensor_core_route(*tensors: torch.Tensor) -> bool:
    """Whether the attention kernels run their bf16 tensor-core variant on
    these tensors (the forward's q, k, v, o; the backward's q, k, v, o, do,
    dq, dk, dv, lse and delta): bf16, and what TMA needs
    (``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``:
    ``mma_aligned``): every tensor starts on 16 bytes and every batch,
    sequence and head stride of a (B, S, heads, D) tensor is a multiple of
    8 elements.  Anything else (f32, or bf16 that breaks that alignment)
    runs the f32 FMA kernels.  Depends on nothing but dtype, strides and
    addresses."""
    if tensors[0].dtype != torch.bfloat16:
        return False
    return all(t.data_ptr() % 16 == 0
               and (t.dim() != 4 or all(s % 8 == 0 for s in t.stride()[:3]))
               for t in tensors)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    if (Bk != B or Dk != D
            or tuple(v.shape[:3]) != tuple(k.shape[:3])):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    if (D, v.shape[3]) not in DIM_PAIRS:
        raise ValueError(f"flash_attention: (query/key, value) head dims "
                         f"{(D, v.shape[3])} not in {DIM_PAIRS}")
    require_sm90(q.device)
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
    if q.numel() and Sk == 0:
        raise ValueError("flash_attention: no keys")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """q: (B, Sq, H, D); k: (B, Sk, K, D); v: (B, Sk, K, Dv) with H % K ==
    0, on one CUDA device, all float32 or all bfloat16, (D, Dv) in
    ``DIM_PAIRS`` and the head dims contiguous (other strides are free).
    Sq and Sk are any lengths.  Scaled by D ** -0.5.  Returns o
    (B, Sq, H, Dv) in q's dtype, contiguous; with ``return_lse`` also each
    row's log-sum-exp (B, H, Sq) f32, and o is bitwise the same either
    way."""
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    Sk, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if o.numel() and q.device.type != "meta":
        stream = torch.cuda.current_stream(q.device).cuda_stream
        strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   *o.stride()[:3]]
        rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    None if lse is None else lse.data_ptr(),
                    DTYPES[q.dtype], B, Sq, Sk, H, K, D, Dv, *strides,
                    int(bool(causal)), int(window), float(D ** -0.5), stream)
        if rc != 0:
            raise RuntimeError(
                f"flash_attention kernel launch failed: CUDA error {rc}")
        flash_attention.launches += 1
        flash_attention.variant_launches[
            "wgmma" if tensor_core_route(q, k, v, o) else "fma"] += 1
        flash_attention.pair_launches[f"{D}x{Dv}"] += 1
    return (o, lse) if return_lse else o


def _bwd_lib():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """(dq, dk, dv) of ``flash_attention`` at upstream gradient ``do``
    (B, Sq, H, Dv), from the forward's o and lse; the layouts and dtypes of
    the forward, dk and dv summed over each GQA group.  The launches (the
    delta pass, dK/dV, dQ; dK/dV in two kernels at (192, 128)) count as one
    call.  The kernels read lse and
    delta rows by TMA, which needs each row to start on 16 bytes: for an Sq
    that is no multiple of 4 the rows are copied into a padded pitch."""
    _check(q, k, v, window)
    B, Sq, H, D = q.shape
    Sk, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(o.shape) != (B, Sq, H, Dv) or tuple(do.shape) != (B, Sq, H, Dv):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be (B, Sq, H, Dv) = "
                         f"{(B, Sq, H, Dv)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError("flash_attention_bwd: o and do must have q's dtype")
    if o.stride(-1) != 1 or do.stride(-1) != 1:
        raise ValueError("flash_attention_bwd: the head dim must be "
                         "contiguous")
    if (tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"(B, H, Sq) = {(B, H, Sq)} float32")
    for t in (o, lse, do):
        if t.device != q.device:
            raise ValueError("flash_attention_bwd: inputs lie on different "
                             "devices")
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, K, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, K, Dv), dtype=q.dtype, device=q.device)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    pitch = -(-Sq // LSE_ROW_ALIGN) * LSE_ROW_ALIGN
    if pitch != Sq:
        lse = torch.nn.functional.pad(lse, (0, pitch - Sq))
    delta = torch.empty((B, H, pitch), dtype=torch.float32, device=q.device)
    if q.device.type == "meta":
        return dq, dk, dv
    strides = (ctypes.c_longlong * 24)(*[
        s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    DTYPES[q.dtype], B, Sq, Sk, H, K, D, Dv, pitch,
                    ctypes.cast(strides, ctypes.c_void_p),
                    int(bool(causal)), int(window), float(D ** -0.5), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.variant_launches[
        "wgmma" if tensor_core_route(q, k, v, o, do, dq, dk, dv, lse, delta)
        else "fma"] += 1
    flash_attention_bwd.pair_launches[f"{D}x{Dv}"] += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.variant_launches = {"wgmma": 0, "fma": 0}
flash_attention.pair_launches = {f"{d}x{dv}": 0 for d, dv in DIM_PAIRS}
flash_attention_bwd.launches = 0
flash_attention_bwd.variant_launches = {"wgmma": 0, "fma": 0}
flash_attention_bwd.pair_launches = {f"{d}x{dv}": 0 for d, dv in DIM_PAIRS}


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable attention over the hand kernels: the forward saves q,
    k, v, o and the log-sum-exp; the backward recomputes the probabilities
    from them.  CPU tensors take the plain versions
    (``ref.flash_attention_fwd_ref`` / ``ref.flash_attention_bwd_ref``), CUDA
    tensors the kernels; there is no fallback in either direction."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        if q.device.type == "cpu":
            o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                 window=window)
        else:
            o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype)
        if do.stride(-1) != 1:
            do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = ref.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                             causal=ctx.causal,
                                             window=ctx.window)
        return dq, dk, dv, None, None

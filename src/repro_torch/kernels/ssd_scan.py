"""CUDA wrappers of the Mamba-2 SSD chunked scan (``csrc/ssd_scan.cu``) and
its backward (``csrc/ssd_scan_bwd.cu``), and the differentiable scan
``SSDScanFn``.

``ssd_scan`` and ``ssd_scan_bwd`` take CUDA tensors only; ``kernels/ops.py``
sends CPU tensors to the plain chunked version ``ref.ssd_chunked_ref``, and
``SSDScanFn`` sends them to ``ref.ssd_chunked_ref`` and
``ref.ssd_scan_bwd_ref``.  The forward has two kernels, chosen by
``tensor_core_route`` from dtype, shape and alignment alone: bf16 at head
dim 64, state 128 (Mamba-2) or 64 (zamba2), chunk 128, TMA-aligned, runs
``ssd_scan_wgmma`` (one block per (batch, head) walking its chunks, state
on chip, products on the tensor cores; the state width a compile-time
parameter); f32 and every other shape run the four f32 FMA passes.  The backward has two as well, chosen by
``tensor_core_bwd_route`` (the forward's route and a contiguous dy): the
bf16 shapes run ``csrc/ssd_scan_bwd_wgmma.cu`` (a forward walk storing the
chunk states, a reverse walk per (batch, head) with dh on chip, a kernel
summing dB and dC over the heads, all on the tensor cores), f32 and every
other shape the f32 FMA passes of ``csrc/ssd_scan_bwd.cu``.  Both
recompute the chunk states from the inputs, so ``SSDScanFn`` saves only x,
dt, a, bm and cm.  ``ssd_scan.launches`` counts the calls that launched a
forward kernel, ``ssd_scan.variant_launches`` the same calls by variant,
and ``ssd_scan_bwd.launches`` / ``.variant_launches`` the backward's.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.sde_step import require_sm90

F32 = torch.float32
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's tile limits (csrc/ssd_scan.cu: QMAX, PMAX, NMAX)
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128


# the tensor-core kernels' shapes (csrc/ssd_scan.cu: kTcQ, kTcP and the
# state widths TcLayout is instantiated at)
TC_CHUNK, TC_HEAD_DIM, TC_STATES = 128, 64, (64, 128)


def _lib():
    fn = _build.load("ssd_scan").ssd_scan_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _tc_lib():
    fn = _build.load("ssd_scan").ssd_scan_wgmma_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    fn = _build.load("ssd_scan_bwd").ssd_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8 + [
            ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_tc_lib():
    fn = _build.load("ssd_scan_bwd_wgmma").ssd_scan_bwd_wgmma
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 + [
            ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def tensor_core_route(x: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                      chunk: int) -> bool:
    """Whether ``ssd_scan`` runs the tensor-core kernel on these inputs:
    bf16, head dim 64, state 64 or 128, a chunk of 128 (``min(chunk, L)``),
    and what TMA needs (``csrc/ssd_scan.cu: tc_aligned``): x, bm and cm
    start on 16 bytes and their batch and token strides are multiples of 8
    elements on every axis longer than one.  Depends on nothing but dtype, shape,
    strides and addresses; the inputs' other checks are ``ssd_scan``'s."""
    B, L, _, P = x.shape
    N = bm.shape[-1]
    if x.dtype != torch.bfloat16 or (min(chunk, L), P) != (
            TC_CHUNK, TC_HEAD_DIM) or N not in TC_STATES:
        return False
    if any(t.data_ptr() % 16 for t in (x, bm, cm)):
        return False
    return all((B == 1 or t.stride(0) % 8 == 0)
               and (L == 1 or t.stride(1) % 8 == 0) for t in (x, bm, cm))


def tensor_core_bwd_route(x: torch.Tensor, bm: torch.Tensor,
                          cm: torch.Tensor, dy: torch.Tensor,
                          chunk: int) -> bool:
    """Whether ``ssd_scan_bwd`` runs the tensor-core backward
    (``csrc/ssd_scan_bwd_wgmma.cu``) on these inputs: the forward's
    ``tensor_core_route`` and a contiguous dy of x's shape and dtype that
    starts on 16 bytes (TMA reads it too).  Depends on nothing but dtype,
    shape, strides and addresses."""
    return (tensor_core_route(x, bm, cm, chunk) and dy.dtype == x.dtype
            and dy.shape == x.shape and dy.is_contiguous()
            and dy.data_ptr() % 16 == 0)


def _check(x, dt, a, bm, cm, chunk: int) -> int:
    require_sm90(x.device)
    if x.dim() != 4 or bm.dim() != 3 or cm.dim() != 3 or dt.dim() != 3:
        raise ValueError("ssd_scan: x (B,L,H,P), dt (B,L,H), bm/cm (B,L,N) "
                         f"expected, got x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, bm {tuple(bm.shape)}, cm "
                         f"{tuple(cm.shape)}")
    B, L, H, P = x.shape
    N = bm.shape[-1]
    if (tuple(dt.shape) != (B, L, H) or tuple(a.shape) != (H,)
            or tuple(bm.shape) != (B, L, N) or tuple(cm.shape) != (B, L, N)):
        raise ValueError(f"ssd_scan: shapes disagree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, bm "
                         f"{tuple(bm.shape)}, cm {tuple(cm.shape)}")
    if not (x.dtype == bm.dtype == cm.dtype) or x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan: x, bm, cm must share one dtype of "
                        f"{list(DTYPES)}, got {x.dtype}, {bm.dtype}, "
                        f"{cm.dtype}")
    if dt.dtype != F32 or a.dtype != F32:
        raise TypeError(f"ssd_scan: dt and a must be float32, got {dt.dtype}"
                        f", {a.dtype}")
    if any(t.device != x.device for t in (dt, a, bm, cm)):
        raise ValueError("ssd_scan: inputs lie on different devices")
    # rows may be strided (column slices of the conv output); within a
    # token, heads and features must be packed
    if (P > 1 and x.stride(3) != 1) or (H > 1 and x.stride(2) != P) or (
            N > 1 and (bm.stride(2) != 1 or cm.stride(2) != 1)):
        raise ValueError("ssd_scan: x must be packed over (H, P) and bm/cm "
                         "over N within each token")
    if not (dt.is_contiguous() and a.is_contiguous()):
        raise ValueError("ssd_scan: dt and a must be contiguous")
    Q = min(chunk, L)
    if B == 0 or L == 0 or L % Q:
        raise ValueError(f"ssd scan: sequence length {L} is no multiple of "
                         f"the chunk {Q}")
    if Q > MAX_CHUNK or P > MAX_HEAD_DIM or N > MAX_STATE:
        raise ValueError(f"ssd_scan: the kernel takes chunk <= {MAX_CHUNK}, "
                         f"head_dim <= {MAX_HEAD_DIM}, d_state <= "
                         f"{MAX_STATE}; got {Q}, {P}, {N}")
    return Q


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,L,H,P); dt: (B,L,H) f32; a: (H,) f32; bm/cm: (B,L,N), all on
    one CUDA device; x, bm and cm float32 or bfloat16.  Returns (y
    (B,L,H,P) in x's dtype, final state (B,H,P,N) float32)."""
    Q = _check(x, dt, a, bm, cm, chunk)
    B, L, H, P = x.shape
    N = bm.shape[-1]
    dev = x.device
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    hT = torch.empty((B, H, P, N), dtype=F32, device=dev)
    meta = dev.type == "meta"
    stream = None if meta else torch.cuda.current_stream(dev).cuda_stream
    strides = (x.stride(0), x.stride(1), bm.stride(0), bm.stride(1),
               cm.stride(0), cm.stride(1))
    if tensor_core_route(x, bm, cm, chunk):
        variant = "wgmma"
        if meta:
            return y, hT
        rc = _tc_lib()(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                       bm.data_ptr(), cm.data_ptr(), y.data_ptr(),
                       hT.data_ptr(), B, L, H, N, *strides, stream)
    else:
        variant = "fma"
        nc = L // Q
        scores = torch.empty((B, nc, Q, Q), dtype=F32, device=dev)
        states = torch.empty((B, nc, H, P, N), dtype=F32, device=dev)
        decay = torch.empty((B, nc, H), dtype=F32, device=dev)
        if meta:
            return y, hT
        rc = _lib()(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                    bm.data_ptr(), cm.data_ptr(), y.data_ptr(),
                    hT.data_ptr(), scores.data_ptr(), states.data_ptr(),
                    decay.data_ptr(), DTYPES[x.dtype], B, L, H, P, N, Q,
                    *strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed ({variant}): "
                           f"CUDA error {rc}")
    ssd_scan.launches += 1
    ssd_scan.variant_launches[variant] += 1
    return y, hT


ssd_scan.launches = 0
ssd_scan.variant_launches = {"wgmma": 0, "fma": 0}


# heads per block of the backward's FMA chunk kernel: the kernel's grid and
# the number of dS partials both follow from it (passed as ``hpb``)
BWD_HEADS_PER_BLOCK = 8
# 32-bit words of one (batch, chunk, head)'s dS^T that the tensor-core
# backward keeps between its kernels (csrc/ssd_scan_bwd_wgmma.cu: kDsWords)
TC_BWD_DS_WORDS = 3 * 2048


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bm: torch.Tensor, cm: torch.Tensor, dy: torch.Tensor,
                 dhT: Optional[torch.Tensor], *, chunk: int = 128
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """(dx, ddt, da, dbm, dcm) of ``ssd_scan`` from a zero state at the
    upstream gradients dy (B,L,H,P) in x's dtype, contiguous, and dhT
    (B,H,P,N) f32 contiguous or ``None`` (zero): dx in x's dtype, ddt and
    da f32, dbm and dcm in bm's dtype, all contiguous.  Inputs as
    ``ssd_scan``, on one CUDA device.  ``tensor_core_bwd_route`` picks the
    kernels: the tensor-core ones for the bf16 shapes at state 64 and 128,
    the f32 FMA passes for the rest."""
    Q = _check(x, dt, a, bm, cm, chunk)
    B, L, H, P = x.shape
    N = bm.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous() \
            or dy.device != x.device:
        raise ValueError(f"ssd_scan_bwd: dy must be a contiguous "
                         f"{tuple(x.shape)} {x.dtype} tensor beside x, got "
                         f"{tuple(dy.shape)} {dy.dtype}")
    if dhT is not None and (tuple(dhT.shape) != (B, H, P, N)
                            or dhT.dtype != F32 or not dhT.is_contiguous()
                            or dhT.device != x.device):
        raise ValueError(f"ssd_scan_bwd: dhT must be a contiguous "
                         f"{(B, H, P, N)} float32 tensor beside x or None, "
                         f"got {tuple(dhT.shape)} {dhT.dtype}")
    dev = x.device
    nc = L // Q
    dx = torch.empty((B, L, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((B, L, H), dtype=F32, device=dev)
    da = torch.empty((H,), dtype=F32, device=dev)
    dbm = torch.empty((B, L, N), dtype=bm.dtype, device=dev)
    dcm = torch.empty((B, L, N), dtype=bm.dtype, device=dev)
    dapart = torch.empty((B, nc, H), dtype=F32, device=dev)
    meta = dev.type == "meta"
    stream = None if meta else torch.cuda.current_stream(dev).cuda_stream
    strides = (x.stride(0), x.stride(1), bm.stride(0), bm.stride(1),
               cm.stride(0), cm.stride(1))
    dh_ptr = None if dhT is None else dhT.data_ptr()
    if tensor_core_bwd_route(x, bm, cm, dy, chunk):
        variant = "wgmma"
        # the chunk states (hi + lo), dh's hi part, each head's dS^T, w and
        # exp(cum), kept between the kernels
        hp_hi, hp_lo, dh_hi = (torch.empty((B, nc, H, P, N), dtype=x.dtype,
                                           device=dev) for _ in range(3))
        ds = torch.empty((B, nc, H, TC_BWD_DS_WORDS), dtype=torch.int32,
                         device=dev)
        wk, ecq = (torch.empty((B, nc, H, Q), dtype=F32, device=dev)
                   for _ in range(2))
        if meta:
            return dx, ddt, da, dbm, dcm
        rc = _bwd_tc_lib()(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), dy.data_ptr(), dh_ptr, dx.data_ptr(),
            ddt.data_ptr(), da.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
            hp_hi.data_ptr(), hp_lo.data_ptr(), dh_hi.data_ptr(),
            ds.data_ptr(), wk.data_ptr(), ecq.data_ptr(), dapart.data_ptr(),
            B, L, H, N, *strides, stream)
    else:
        variant = "fma"
        G = -(-H // BWD_HEADS_PER_BLOCK)
        scores = torch.empty((B, nc, Q, Q), dtype=F32, device=dev)
        states = torch.empty((B, nc, H, P, N), dtype=F32, device=dev)
        dh = torch.empty((B, nc, H, P, N), dtype=F32, device=dev)
        decay = torch.empty((B, nc, H), dtype=F32, device=dev)
        dspart = torch.empty((B, nc, G, Q, Q), dtype=F32, device=dev)
        if meta:
            return dx, ddt, da, dbm, dcm
        rc = _bwd_lib()(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), dy.data_ptr(), dh_ptr, dx.data_ptr(),
            ddt.data_ptr(), da.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
            scores.data_ptr(), states.data_ptr(), decay.data_ptr(),
            dh.data_ptr(), dapart.data_ptr(), dspart.data_ptr(),
            DTYPES[x.dtype], B, L, H, P, N, Q, BWD_HEADS_PER_BLOCK,
            *strides, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed ({variant}): "
                           f"CUDA error {rc}")
    ssd_scan_bwd.launches += 1
    ssd_scan_bwd.variant_launches[variant] += 1
    return dx, ddt, da, dbm, dcm


ssd_scan_bwd.launches = 0
ssd_scan_bwd.variant_launches = {"wgmma": 0, "fma": 0}


class SSDScanFn(torch.autograd.Function):
    """The differentiable scan from a zero state: (y, final state).  The
    forward takes the route serving takes (``ssd_scan``) and saves only its
    inputs; the backward recomputes the chunk states from them.  CPU tensors
    take the plain versions (``ref.ssd_chunked_ref`` /
    ``ref.ssd_scan_bwd_ref``), CUDA tensors the kernels; there is no
    fallback in either direction.  An unused final state (training calls
    the scan without a cache) reaches the backward as ``None``."""

    @staticmethod
    def forward(ctx, x, dt, a, bm, cm, chunk: int):
        if x.device.type == "cpu":
            y, hT = ref.ssd_chunked_ref(x, dt, a, bm, cm, chunk)
        else:
            y, hT = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
        ctx.save_for_backward(x, dt, a, bm, cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        x, dt, a, bm, cm = ctx.saved_tensors
        dy = (torch.zeros_like(x) if dy is None
              else dy.to(x.dtype).contiguous())
        if dhT is not None:
            dhT = dhT.to(F32).contiguous()
        if x.device.type == "cpu":
            grads = ref.ssd_scan_bwd_ref(x, dt, a, bm, cm, dy, dhT,
                                         ctx.chunk)
        else:
            grads = ssd_scan_bwd(x, dt, a, bm, cm, dy, dhT, chunk=ctx.chunk)
        return (*grads, None)

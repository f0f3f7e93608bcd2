"""CUDA wrapper of the fused Flow-SDE step (``csrc/sde_step.cu``).

``sde_step`` takes CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to
the plain version in ``kernels/ref.py``.  ``sde_step.launches`` counts the
calls that launched the kernel.  On ``meta`` tensors (the dry run,
``launch/dryrun.py``) every wrapper of this package checks its inputs,
allocates every buffer its card route allocates and returns them without
launching (and without counting).
"""
from __future__ import annotations

import ctypes
import numbers
from typing import Tuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# elements of one row that one block covers, at most; rows are cut into
# ceil(feat / CHUNK) chunks (so a batch of four 4096x64 latents runs 512
# blocks on the card's 132 SMs)
CHUNK = 2048


def _lib():
    lib = _build.load("sde_step")
    fn = lib.sde_step_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def require_sm90(device: torch.device) -> None:
    """Raise unless ``device`` is an sm_90 card; a ``meta`` device (the
    dry run's route, which launches nothing) passes unchecked."""
    if device.type == "meta":
        return
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    cap = torch.cuda.get_device_capability(device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (H100/H200); "
            f"{torch.cuda.get_device_name(device)} has capability {cap}")


def sde_step(v: torch.Tensor, x: torch.Tensor, eps: torch.Tensor, t, t_next,
             *, eta: float = 0.7) -> Tuple[torch.Tensor, torch.Tensor]:
    """v, x, eps: (B, ...) on one CUDA device, contiguous, all float32 or all
    bfloat16; t, t_next: Python numbers (passed by value).  Returns
    (x_next (B, ...) float32, logp (B,) float32)."""
    for name, a in (("t", t), ("t_next", t_next), ("eta", eta)):
        if not isinstance(a, numbers.Real):
            raise TypeError(f"sde_step: {name} must be a host number (passed "
                            f"to the kernel by value), got {type(a).__name__}")
    require_sm90(x.device)
    if not (v.shape == x.shape == eps.shape):
        raise ValueError(f"sde_step: shapes differ: v {tuple(v.shape)}, "
                         f"x {tuple(x.shape)}, eps {tuple(eps.shape)}")
    if not (v.dtype == x.dtype == eps.dtype) or x.dtype not in DTYPES:
        raise TypeError(f"sde_step: v, x, eps must share one dtype of "
                        f"{list(DTYPES)}, got {v.dtype}, {x.dtype}, "
                        f"{eps.dtype}")
    if not (v.device == x.device == eps.device):
        raise ValueError("sde_step: v, x, eps lie on different devices")
    if not (v.is_contiguous() and x.is_contiguous() and eps.is_contiguous()):
        raise ValueError("sde_step: v, x, eps must be contiguous")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"sde_step: empty input of shape {tuple(x.shape)}")
    B = x.shape[0]
    feat = x.numel() // B
    nblk = -(-feat // CHUNK)
    x_next = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    logp = torch.empty((B,), dtype=torch.float32, device=x.device)
    partials = torch.empty((B * nblk,), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":
        return x_next, logp
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib()(v.data_ptr(), x.data_ptr(), eps.data_ptr(),
                x_next.data_ptr(), partials.data_ptr(), logp.data_ptr(),
                DTYPES[x.dtype], B, feat, nblk, float(t), float(t_next),
                float(eta), stream)
    if rc != 0:
        raise RuntimeError(f"sde_step kernel launch failed: CUDA error {rc}")
    sde_step.launches += 1
    return x_next, logp


sde_step.launches = 0

"""Mamba2 SSD block (state-space duality, arXiv:2405.21060) — the port of
``repro.models.ssm``, full-sequence path.

The sequence transform is the chunked SSD scan, run through
``kernels.ops.ssd_scan``: the hand-written kernel on a CUDA tensor, the
plain chunked version on a CPU tensor.  Rounding follows the reference:
``in_proj`` accumulates in f32 and is cast to the activation dtype; the
depthwise conv accumulates tap by tap in f32, then applies silu and casts;
softplus of dt runs in f32; ``d_skip`` is added in the activation dtype; the
gated RMSNorm and an f32-accumulated ``out_proj`` come last.  The one-token
decode path (``apply_decode``, ``ssd_decode_step``) is plain PyTorch, as the
reference computes it in jnp: the conv over the cached inputs and the new
one, then one step of the recurrence on the f32 state.

Shapes (per layer):
  x   (B, L, H, P)   values (H = d_inner/head_dim heads, P = head_dim)
  dt  (B, L, H)      positive step sizes (softplus)
  A   (H,)           negative decay rates
  Bm  (B, L, N)      input projections (single state group, mamba2 default)
  Cm  (B, L, N)      output projections
  state (B, H, P, N) recurrent state
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import P

F32 = torch.float32


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, conv_dim) trailing conv inputs
    state: torch.Tensor   # (B, H, P, N)


def dims(cfg: ArchConfig) -> Dict[str, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return dict(d_in=d_in, H=H, P=s.head_dim, N=s.d_state,
                conv_dim=conv_dim, Q=s.chunk, d_conv=s.d_conv)


def spec(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    m = dims(cfg)
    proj_out = 2 * m["d_in"] + 2 * m["N"] + m["H"]
    return {
        "in_proj": P((d, proj_out), ("embed", "inner")),
        "conv_w": P((m["d_conv"], m["conv_dim"]), ("conv", "inner"), "small"),
        "conv_b": P((m["conv_dim"],), ("inner",), "zeros"),
        "a_log": P((m["H"],), ("ssm_heads",), "small", 0.5),
        "d_skip": P((m["H"],), ("ssm_heads",), "ones"),
        "dt_bias": P((m["H"],), ("ssm_heads",), "small", 0.5),
        "norm": P((m["d_in"],), ("inner",), "ones"),
        "out_proj": P((m["d_in"], d), ("inner", "embed_r")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. u: (B, L, C); w: (K, C); returns (B, L, C).
    The taps are summed one by one in f32 (no cuDNN: its f32 convolutions
    run in TF32 by default)."""
    K, L = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, K - 1, 0)).to(F32)
    wf = w.to(F32)
    # the reference's sum 0 + p0 + p1 + ..., rounded at the same places
    out = up[:, :L] * wf[0]
    for i in range(1, K):
        out += up[:, i:i + L] * wf[i]
    return F.silu(out + b.to(F32)).to(u.dtype)


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    m = dims(cfg)
    return torch.split(zxbcdt, [m["d_in"], m["d_in"], 2 * m["N"], m["H"]],
                       dim=-1)


def apply_full(p: Dict, cfg: ArchConfig, x: torch.Tensor, *,
               return_cache: bool = False
               ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Full-sequence SSD block. x: (B, S, d)."""
    m = dims(cfg)
    B, S, _ = x.shape
    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype)).to(x.dtype)
    z, xin, bc, dt_raw = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out = _causal_conv(conv_in, p["conv_w"], p["conv_b"])
    xin = conv_out[..., :m["d_in"]]
    bm = conv_out[..., m["d_in"]:m["d_in"] + m["N"]]
    cm = conv_out[..., m["d_in"] + m["N"]:]
    dt = F.softplus(dt_raw.to(F32) + p["dt_bias"].to(F32)).contiguous()
    a = -torch.exp(p["a_log"].to(F32))
    xh = xin.reshape(B, S, m["H"], m["P"])
    y, final_state = ops.ssd_scan(xh, dt, a, bm, cm, chunk=m["Q"])
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, m["d_in"])
    y = layers.rmsnorm(p["norm"], y * F.silu(z.to(F32)).to(x.dtype),
                       cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"].to(y.dtype)).to(x.dtype)
    cache = None
    if return_cache:
        cache = SSMCache(conv=conv_in[:, S - (m["d_conv"] - 1):, :],
                         state=final_state)
    return out, cache


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. state (B,H,P,N); x (B,H,P); dt (B,H);
    bm/cm (B,N). Returns (y (B,H,P), new_state (f32))."""
    dA = torch.exp(dt.to(F32) * a.to(F32))                # (B,H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt.to(F32), bm.to(F32),
                       x.to(F32))
    new_state = state.to(F32) * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, cm.to(F32))
    return y.to(x.dtype), new_state


def apply_decode(p: Dict, cfg: ArchConfig, x: torch.Tensor, cache: SSMCache
                 ) -> Tuple[torch.Tensor, SSMCache]:
    """One-token decode. x: (B, 1, d).  Returns the output and the new
    cache (the conv window moved by one; the state after this token)."""
    m = dims(cfg)
    B = x.shape[0]
    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype)).to(x.dtype)
    z, xin, bc, dt_raw = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([xin, bc], dim=-1)                 # (B,1,conv_dim)
    full = torch.cat([cache.conv.to(x.dtype), conv_in], dim=1)
    co = (full.to(F32) * p["conv_w"].to(F32)[None]).sum(dim=1) \
        + p["conv_b"].to(F32)
    co = F.silu(co).to(x.dtype)                            # (B, conv_dim)
    xin1 = co[:, :m["d_in"]].reshape(B, m["H"], m["P"])
    bm1 = co[:, m["d_in"]:m["d_in"] + m["N"]]
    cm1 = co[:, m["d_in"] + m["N"]:]
    dt = F.softplus(dt_raw[:, 0].to(F32) + p["dt_bias"].to(F32))
    a = -torch.exp(p["a_log"].to(F32))
    y, new_state = ssd_decode_step(cache.state, xin1, dt, a, bm1, cm1)
    y = y + xin1 * p["d_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(B, 1, m["d_in"])
    y = layers.rmsnorm(p["norm"], y * F.silu(z.to(F32)).to(x.dtype),
                       cfg.norm_eps)
    out = torch.matmul(y, p["out_proj"].to(y.dtype)).to(x.dtype)
    return out, SSMCache(conv=full[:, 1:, :], state=new_state)


def init_cache_shapes(cfg: ArchConfig, batch: int):
    m = dims(cfg)
    return {
        "conv": ((batch, m["d_conv"] - 1, m["conv_dim"]),
                 ("batch", None, "inner")),
        "state": ((batch, m["H"], m["P"], m["N"]),
                  ("batch", "ssm_heads", None, None)),
    }

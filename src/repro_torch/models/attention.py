"""GQA attention block: param spec + full-sequence application.

Grouped-query attention with optional per-head q/k RMSNorm and RoPE, as in
``repro.models.attention``.  ``apply_full`` sends the attention itself
through ``kernels.ops.flash_attention`` (the hand-written kernel for CUDA
tensors) where the reference calls the jnp ``attention_chunked``; when q, k
or v requires grad (the training loss) the call returns through
``FlashAttentionFn``, whose backward is the hand-written attention-backward
kernel, and the forward's output is bitwise the one the rollout saw.
Decode and KV caches come with the causal families.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import P


def spec(cfg: ArchConfig) -> Dict:
    d, H, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    s = {
        "wq": P((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, K, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, K, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((H, hd, d), ("heads", "head_dim", "embed_r")),
    }
    if cfg.qk_norm:
        s["q_norm"] = P((hd,), ("head_dim",), "ones")
        s["k_norm"] = P((hd,), ("head_dim",), "ones")
    return s


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) x (d, N, hd) -> (B, S, N, hd) in x's dtype."""
    d, n, hd = w.shape
    out = torch.matmul(x, w.reshape(d, n * hd))
    return out.reshape(*x.shape[:-1], n, hd).to(x.dtype)


def _qkv(p: Dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = layers.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_full(p: Dict, cfg: ArchConfig, x: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention. x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    H, hd, d = p["wo"].shape
    return torch.matmul(o.reshape(B, S, H * hd),
                        p["wo"].reshape(H * hd, d)).to(x.dtype)

"""GQA attention block: param spec + full-sequence / decode application.

Grouped-query attention with optional per-head q/k RMSNorm and RoPE, as in
``repro.models.attention``.  ``apply_full`` sends the attention itself
through ``kernels.ops.flash_attention`` (the hand-written kernel for CUDA
tensors) where the reference calls the jnp ``attention_chunked``; when q, k
or v requires grad (the training loss) the call returns through
``FlashAttentionFn``, whose backward is the hand-written attention-backward
kernel, and the forward's output is bitwise the one the rollout saw.
``apply_full(return_cache=True)`` also returns the layer's roped keys and
values (prefill).  ``apply_decode`` runs one token against a cache in
plain PyTorch (``layers.attend_one``), as the reference does in jnp, and
rolls the cache: the oldest entry out, the new one in.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import P


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, T, K, D)
    v: torch.Tensor     # (B, T, K, D)


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
    out = torch.matmul(x, w.to(x.dtype).reshape(d, n * hd))
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


def _out(p: Dict, o: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    H, hd, d = p["wo"].shape
    return torch.matmul(o.reshape(B, S, H * hd),
                        p["wo"].to(x.dtype).reshape(H * hd, d)).to(x.dtype)


def apply_full(p: Dict, cfg: ArchConfig, x: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               positions: Optional[torch.Tensor] = None,
               return_cache: bool = False
               ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Full-sequence attention (train / prefill). x: (B, S, d) ->
    ((B, S, d), the layer's KVCache or None)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, cfg, x, positions)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return _out(p, o, x), (KVCache(k, v) if return_cache else None)


def apply_decode(p: Dict, cfg: ArchConfig, x: torch.Tensor, cache: KVCache,
                 pos: int, *, window: int = 0
                 ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, d); pos: the new token's absolute
    position.  The cache holds the previous ``T`` entries (window-sized
    when sliding windows are active).  Returns the output and the rolled
    cache: the oldest entry out, the new one in (views of the joined
    tensors the attention read; the caller stores them)."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    k = torch.cat([cache.k, k_new], dim=1)
    v = torch.cat([cache.v, v_new], dim=1)
    o = layers.attend_one(q, k, v)
    return _out(p, o, x), KVCache(k[:, 1:], v[:, 1:])


def init_cache_shape(cfg: ArchConfig, batch: int, cache_len: int
                     ) -> Tuple[Tuple[int, ...], Tuple]:
    hd = cfg.resolved_head_dim
    shape = (batch, cache_len, cfg.n_kv_heads, hd)
    axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    return shape, axes

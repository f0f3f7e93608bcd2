"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the
train/prefill path of ``repro.models.mla``.

Keys and values are compressed into a rank-``kv_lora_rank`` latent ``c_kv``
plus a small RoPE key shared by every head; ``apply_full`` expands the
latent into per-head keys and values.  Queries and keys are
``qk_nope_head_dim + qk_rope_head_dim`` wide (192 in deepseek-v2-236b),
values ``v_head_dim`` (128), and the scale is the query width's
``192 ** -0.5``.  The attention goes through ``kernels.ops.flash_attention``
(the hand-written kernels at a value dim unlike the query dim, and
``FlashAttentionFn`` when the loss differentiates it) where the reference
calls its jnp ``attention_chunked``.

The up-projections ``w_uq``/``w_uk``/``w_uv`` and ``wo`` carry the "heads"
logical axis, so on a "model" axis the ``PartitionPlan`` shards them
head-parallel; the latent down-projections carry "q_lora"/"kv_lora" and
fall back to embed sharding.

The absorbed decode path (``apply_decode``), ``MLACache`` and the cache
shapes come with the other decode paths (ROADMAP.md Queue 1, item 16.5).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import P


def spec(cfg: ArchConfig) -> Dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": P((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_norm": P((m.q_lora_rank,), ("norm",), "ones"),
        "w_uq": P((m.q_lora_rank, H, qk), ("q_lora", "heads", "head_dim")),
        "w_dkv": P((d, m.kv_lora_rank + m.qk_rope_head_dim),
                   ("embed", "kv_lora")),
        "kv_norm": P((m.kv_lora_rank,), ("norm",), "ones"),
        "w_uk": P((m.kv_lora_rank, H, m.qk_nope_head_dim),
                  ("kv_lora", "heads", "head_dim")),
        "w_uv": P((m.kv_lora_rank, H, m.v_head_dim),
                  ("kv_lora", "heads", "head_dim")),
        "wo": P((H, m.v_head_dim, d), ("heads", "head_dim", "embed_r")),
    }


def _up(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, r) x (r, H, k) -> (B, S, H, k) in x's dtype."""
    r, h, k = w.shape
    out = torch.matmul(x, w.to(x.dtype).reshape(r, h * k))
    return out.reshape(*x.shape[:-1], h, k).to(x.dtype)


def _q_proj(p: Dict, cfg: ArchConfig, x: torch.Tensor,
            positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q_nope (B,S,H,Dn), q_rope (B,S,H,Dr))."""
    m = cfg.mla
    cq = layers.rmsnorm(p["q_norm"],
                        torch.matmul(x, p["w_dq"].to(x.dtype)).to(x.dtype),
                        cfg.norm_eps)
    q = _up(cq, p["w_uq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = layers.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                               cfg.rope_theta)
    return q_nope, q_rope


def _kv_latent(p: Dict, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (c_kv (B,S,R), k_rope (B,S,Dr))."""
    m = cfg.mla
    dkv = torch.matmul(x, p["w_dkv"].to(x.dtype)).to(x.dtype)
    c_kv = layers.rmsnorm(p["kv_norm"], dkv[..., :m.kv_lora_rank],
                          cfg.norm_eps)
    k_rope = layers.apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :],
                               positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def apply_full(p: Dict, cfg: ArchConfig, x: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train/prefill path: expand the latent into per-head K/V.
    x: (B, S, d) -> (B, S, d)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _q_proj(p, cfg, x, positions)
    c_kv, k_rope = _kv_latent(p, cfg, x, positions)
    k_nope = _up(c_kv, p["w_uk"])
    v = _up(c_kv, p["w_uv"])
    # nope + rope in one (B, S, H, 192) operand; the rope key is shared by
    # every head
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return torch.matmul(o.reshape(B, S, H * m.v_head_dim),
                        p["wo"].to(x.dtype).reshape(H * m.v_head_dim,
                                                    cfg.d_model)).to(x.dtype)

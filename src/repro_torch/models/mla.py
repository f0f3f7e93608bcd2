"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434): the
port of ``repro.models.mla``, train/prefill and absorbed decode.

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

The cache (``MLACache``) holds the rank-compressed latent ``c_kv`` and the
shared RoPE key, never per-head keys and values.  ``apply_decode`` is the
reference's absorbed decode, in plain PyTorch as the reference's jnp:
``W_uk`` is folded into the query and ``W_uv`` into the output, so the
attention runs in the rank-``kv_lora_rank`` latent space; the cache then
rolls (oldest entry out).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import P


F32 = torch.float32


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (B, T, kv_lora_rank)
    k_rope: torch.Tensor   # (B, T, qk_rope_head_dim)


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
               positions: Optional[torch.Tensor] = None,
               return_cache: bool = False
               ) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """Train/prefill path: expand the latent into per-head K/V.
    x: (B, S, d) -> ((B, S, d), the layer's MLACache or None)."""
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
    out = torch.matmul(o.reshape(B, S, H * m.v_head_dim),
                       p["wo"].to(x.dtype).reshape(H * m.v_head_dim,
                                                   cfg.d_model)).to(x.dtype)
    return out, (MLACache(c_kv, k_rope) if return_cache else None)


def apply_decode(p: Dict, cfg: ArchConfig, x: torch.Tensor, cache: MLACache,
                 pos: int, *, window: int = 0
                 ) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed decode: attention runs in the rank-R latent space.

    scores_h = q_nope_h · W_uk_h · c_kv  +  q_rope_h · k_rope
    out_h    = (softmax · c_kv) · W_uv_h

    Products take f32 operands (the reference's f32 accumulation) and
    round to the activation dtype where the reference casts.  Returns the
    output and the rolled cache (views of the joined tensors)."""
    m = cfg.mla
    dt = x.dtype
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _q_proj(p, cfg, x, positions)       # (B,1,H,*)
    c_new, kr_new = _kv_latent(p, cfg, x, positions)     # (B,1,R),(B,1,Dr)
    # attend over the FULL cache plus the new entry (T+1)...
    c_kv = torch.cat([cache.c_kv, c_new], dim=1)
    k_rope = torch.cat([cache.k_rope, kr_new], dim=1)
    # absorb W_uk into the query: (B,H,R)
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0].to(F32),
                         p["w_uk"].to(F32)).to(dt)
    c_f = c_kv.to(F32)
    s_nope = torch.einsum("bhr,btr->bht", q_abs.to(F32), c_f)
    s_rope = torch.einsum("bhk,btk->bht", q_rope[:, 0].to(F32),
                          k_rope.to(F32))
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    w = torch.softmax((s_nope + s_rope) * scale, dim=-1).to(dt)
    o_lat = torch.einsum("bht,btr->bhr", w.to(F32), c_f).to(dt)
    # absorb W_uv on the way out
    o = torch.einsum("bhr,rhk->bhk", o_lat.to(F32), p["w_uv"].to(F32)).to(dt)
    res = torch.einsum("bhk,hkd->bd", o.to(F32),
                       p["wo"].to(F32))[:, None, :].to(dt)
    # ...then roll the ring buffer (oldest entry out, shape stays static)
    return res, MLACache(c_kv[:, 1:], k_rope[:, 1:])


def init_cache_shapes(cfg: ArchConfig, batch: int, cache_len: int):
    m = cfg.mla
    return {
        "c_kv": ((batch, cache_len, m.kv_lora_rank),
                 ("batch", "cache_seq", "kv_lora")),
        "k_rope": ((batch, cache_len, m.qk_rope_head_dim),
                   ("batch", "cache_seq", "head_dim")),
    }

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

Tensor parallel over "model" (the production layout of
``repro_torch.sharding``): when ``w_uq`` holds fewer heads than
``cfg.n_heads`` it is this rank's shard, and the block runs its local
heads, read from the shards' shapes.  The latent projections and their
norms (``w_dq``, ``q_norm``, ``w_dkv``, ``kv_norm``) are whole on every
rank, which computes the same ``cq``, ``c_kv`` and ``k_rope``; these
three enter the heads through *f* (``sharding.copy_to_model``), since
each rank's gradient into them is a partial sum over its own heads.
That one all-reduce of the latents (``q_lora_rank + kv_lora_rank +
qk_rope_head_dim`` values a token) stands for those of x and of the four
whole weights, whose gradients are then whole on every rank.  ``w_uq``,
``w_uk`` and ``w_uv`` produce the local heads; ``wo``'s rows are the
local heads, so its output is a partial sum, kept f32
(``layers.row_parallel``), that *g* (``sharding.reduce_from_model``)
adds and rounds once; under ``REPRO_BF16_REDUCE`` the partial is rounded
to bf16 on the rank and summed in bf16, as at every row-parallel site
(the reference's MLA asks its ``wo`` products for f32 in either case,
``repro/models/mla.py``; the port applies the switch to every site
alike).  The absorbed decode runs per local head the same
way against the latent cache, which has no heads axis and stays whole on
every "model" rank unless the rules split its sequence.  With whole
heads the block is the single-device one.

Sequence-sharded decode (``sharding.current_seq``, the reference's
``cache_seq`` rule): rank r of the cache's axis holds entries
[r·T/n, (r+1)·T/n) of ``c_kv`` and ``k_rope``.  The absorbed queries
``q_abs`` and ``q_rope`` are gathered over "model" when the heads are a
shard over that axis, each rank scores every head on its segment (the
last rank the new entry too), the softmax is merged over the axis
(``layers.merged_softmax``), the f32 ``o_lat`` partials are all-reduced
and rounded once, each rank keeps its heads' rows, and the ring rolls
across the segments (``layers.roll_segments``).

On the activation-gathered route the latent down-projections go
through ``layers.dense`` and ``wo`` through ``layers.row_parallel`` (the
absorbed decode's f32 ``wo`` product through ``sharding.rows_out_value``):
each keeps its "data" shard and moves rows.

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

from repro_torch import sharding as shlib
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


def _q_latent(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """cq (B,S,q_lora_rank): the normed query latent."""
    return layers.rmsnorm(p["q_norm"], layers.dense(x, p["w_dq"]),
                          cfg.norm_eps)


def _q_proj(p: Dict, cfg: ArchConfig, cq: torch.Tensor,
            positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q_nope (B,S,H,Dn), q_rope (B,S,H,Dr)) of the heads
    ``w_uq`` holds."""
    m = cfg.mla
    q = _up(cq, p["w_uq"])
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = layers.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                               cfg.rope_theta)
    return q_nope, q_rope


def _kv_latent(p: Dict, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (c_kv (B,S,R), k_rope (B,S,Dr))."""
    m = cfg.mla
    dkv = layers.dense(x, p["w_dkv"])
    c_kv = layers.rmsnorm(p["kv_norm"], dkv[..., :m.kv_lora_rank],
                          cfg.norm_eps)
    k_rope = layers.apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :],
                               positions, cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _latents(p: Dict, cfg: ArchConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """(c_kv, k_rope, (cq, c_kv, k_rope) as the heads read them, tp): the
    latents of x (c_kv and k_rope as the cache keeps them), the heads'
    copies of all three through *f* under tensor parallelism (``tp`` not
    None: ``w_uq`` holds this rank's heads), themselves without."""
    cq = _q_latent(p, cfg, x)
    c_kv, k_rope = _kv_latent(p, cfg, x, positions)
    tp = shlib.tp_for(p["w_uq"].shape[1], cfg.n_heads)
    lat = (cq, c_kv, k_rope)
    if tp is not None:
        lat = tuple(shlib.copy_to_model(t, tp) for t in lat)
    return c_kv, k_rope, lat, tp


def apply_full(p: Dict, cfg: ArchConfig, x: torch.Tensor, *,
               causal: bool = True, window: int = 0,
               positions: Optional[torch.Tensor] = None,
               return_cache: bool = False
               ) -> Tuple[torch.Tensor, Optional[MLACache]]:
    """Train/prefill path: expand the latent into per-head K/V (this
    rank's heads under tensor parallelism).
    x: (B, S, d) -> ((B, S, d), the layer's MLACache or None)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = p["w_uq"].shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    c_kv, k_rope, (cq, c_h, kr_h), tp = _latents(p, cfg, x, positions)
    q_nope, q_rope = _q_proj(p, cfg, cq, positions)
    k_nope = _up(c_h, p["w_uk"])
    v = _up(c_h, p["w_uv"])
    # nope + rope in one (B, S, H, 192) operand; the rope key is shared by
    # every head
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr_h[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    out = layers.row_parallel(o.reshape(B, S, H * m.v_head_dim),
                              p["wo"].reshape(H * m.v_head_dim, -1), tp,
                              cfg.d_model)
    if tp is not None:
        out = shlib.reduce_from_model(out, tp, x.dtype)
    if not return_cache:
        return out, None
    return out, MLACache(shlib.seq_segment(c_kv), shlib.seq_segment(k_rope))


def apply_decode(p: Dict, cfg: ArchConfig, x: torch.Tensor, cache: MLACache,
                 pos: int, *, window: int = 0
                 ) -> Tuple[torch.Tensor, MLACache]:
    """Absorbed decode: attention runs in the rank-R latent space.

    scores_h = q_nope_h · W_uk_h · c_kv  +  q_rope_h · k_rope
    out_h    = (softmax · c_kv) · W_uv_h

    Products take f32 operands (the reference's f32 accumulation) and
    round to the activation dtype where the reference casts.  Under tensor
    parallelism h runs over this rank's heads and the output is the
    ranks' f32 sum.  Returns the output and the rolled cache (views of the
    joined tensors)."""
    m = cfg.mla
    dt = x.dtype
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    c_new, kr_new, (cq, _, _), tp = _latents(p, cfg, x, positions)
    q_nope, q_rope = _q_proj(p, cfg, cq, positions)      # (B,1,H,*)
    # absorb W_uk into the query: (B,H,R)
    q_abs = torch.einsum("bhk,rhk->bhr", q_nope[:, 0].to(F32),
                         p["w_uk"].to(F32)).to(dt)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    seq = shlib.current_seq()
    if seq is not None:
        o_lat, new_cache = _segment_latent(cache, c_new, kr_new, q_abs,
                                           q_rope[:, 0], scale, tp, seq)
    else:
        # attend over the FULL cache plus the new entry (T+1)...
        c_kv = torch.cat([cache.c_kv, c_new], dim=1)
        k_rope = torch.cat([cache.k_rope, kr_new], dim=1)
        c_f = c_kv.to(F32)
        s_nope = torch.einsum("bhr,btr->bht", q_abs.to(F32), c_f)
        s_rope = torch.einsum("bhk,btk->bht", q_rope[:, 0].to(F32),
                              k_rope.to(F32))
        w = torch.softmax((s_nope + s_rope) * scale, dim=-1).to(dt)
        o_lat = torch.einsum("bht,btr->bhr", w.to(F32), c_f).to(dt)
        # ...then roll the ring buffer (oldest entry out, shape static)
        new_cache = MLACache(c_kv[:, 1:], k_rope[:, 1:])
    # absorb W_uv on the way out
    o = torch.einsum("bhr,rhk->bhk", o_lat.to(F32), p["w_uv"].to(F32)).to(dt)
    rows = shlib.rows_for(p["wo"].shape[-1], cfg.d_model)
    if rows is None:
        res = torch.einsum("bhk,hkd->bd", o.to(F32), p["wo"].to(F32))
    else:   # wo's d a "data" shard: the rows gathered, the columns home
        res = shlib.rows_out_value(o.to(F32).flatten(1),
                                   p["wo"].to(F32).flatten(0, 1), rows,
                                   torch.mm)
    if tp is not None:   # the f32 partial, or bf16 under the switch
        res = shlib.reduce_from_model(shlib.Partial(
            res.to(layers.reduce_dtype()), shlib.carrier(res, dt)), tp, dt)
    return res[:, None, :].to(dt), new_cache


def _segment_latent(cache: MLACache, c_new: torch.Tensor,
                    kr_new: torch.Tensor, q_abs: torch.Tensor,
                    q_rope: torch.Tensor, scale: float, tp, seq
                    ) -> Tuple[torch.Tensor, MLACache]:
    """The absorbed attention over a latent cache whose sequence is split
    over ``seq`` (module docstring): (o_lat (B, H, R) of this rank's
    heads, in q_abs's dtype; the rolled segments)."""
    dt = q_abs.dtype
    h = q_abs.shape[1]
    every_head = tp is not None and seq.axis == "model"
    if every_head:
        q_abs = shlib.gather_model(q_abs, 1, tp)
        q_rope = shlib.gather_model(q_rope, 1, tp)
    qa, qr = q_abs.to(F32), q_rope.to(F32)
    c_f = cache.c_kv.to(F32)
    s = (torch.einsum("bhr,btr->bht", qa, c_f)
         + torch.einsum("bhk,btk->bht", qr, cache.k_rope.to(F32)))
    last = seq.rank == seq.size - 1
    if last:
        s_new = (torch.einsum("bhr,br->bh", qa, c_new[:, 0].to(F32))
                 + torch.einsum("bhk,bk->bh", qr, kr_new[:, 0].to(F32)))
        s = torch.cat([s, s_new[..., None]], dim=-1)
    T = c_f.shape[1]
    w = layers.merged_softmax(s * scale, seq, dt).to(F32)
    o_lat = torch.einsum("bht,btr->bhr", w[..., :T], c_f)
    if last:
        o_lat += w[..., T:] * c_new[:, 0].to(F32)[:, None, :]
    o_lat = shlib.all_reduce_sum_(o_lat, seq.group).to(dt)
    if every_head:
        o_lat = o_lat[:, tp.rank * h:(tp.rank + 1) * h]
    return o_lat, MLACache(*layers.roll_segments(
        (cache.c_kv, cache.k_rope), (c_new, kr_new), seq))


def init_cache_shapes(cfg: ArchConfig, batch: int, cache_len: int):
    m = cfg.mla
    return {
        "c_kv": ((batch, cache_len, m.kv_lora_rank),
                 ("batch", "cache_seq", "kv_lora")),
        "k_rope": ((batch, cache_len, m.qk_rope_head_dim),
                   ("batch", "cache_seq", "head_dim")),
    }

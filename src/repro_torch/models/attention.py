"""GQA attention block: param spec + full-sequence / decode application.

Grouped-query attention with optional per-head q/k RMSNorm and RoPE, as in
``repro.models.attention``.  ``apply_full`` sends the attention itself
through ``kernels.ops.flash_attention`` (the hand-written kernel for CUDA
tensors) where the reference calls the jnp ``attention_chunked``; when q, k
or v requires grad (the training loss) the call returns through
``FlashAttentionFn``, whose backward is the hand-written attention-backward
kernel, and the forward's output is bitwise the one the rollout saw.
``apply_full(return_cache=True)`` also returns the layer's roped keys and
values (prefill; this rank's segment of them when the rules split the
cache's sequence).  ``apply_decode`` runs one token against a cache in
plain PyTorch (``layers.attend_one``), as the reference does in jnp, and
rolls the cache: the oldest entry out, the new one in.

Tensor parallel over "model" (the production layout of
``repro_torch.sharding``): when ``wq`` holds fewer heads than
``cfg.n_heads`` it is this rank's column shard, and the block runs its
local heads, read from the shards' shapes.  x enters through *f*
(``sharding.copy_to_model``); q, k and v are projected for the local
heads; the kernel runs on them; ``wo`` is row-parallel and its partial
outputs are summed by *g* (``sharding.reduce_from_model``).  Where the kv
heads do not shard (fewer than the "model" ranks, or not a multiple),
every rank holds ``wk`` / ``wv`` whole, projects every kv head (so a
prefill or decode cache stays whole, as the reference's cache layout
keeps it) and slices the kv heads its q heads read; those weights, and
``q_norm`` / ``k_norm``, enter through *f* as well, so their gradient is
the sum of the ranks' parts.  ``wo``'s partial product stays f32 until
*g* has summed it.  With whole heads the block is the single-device one.

On the activation-gathered route (``sharding.current_rows``) ``wq``,
``wk``, ``wv`` keep their "data" shard of d and go through
``layers.dense``, ``wo`` through ``layers.row_parallel``: the rows move
over "data" instead of the weights.

Sequence-sharded decode (``sharding.current_seq``: the reference's
``cache_seq`` rule): rank r of the cache's axis holds entries
[r·T/n, (r+1)·T/n) of the ring.  Each rank scores its segment (the last
rank the new entry too), the softmax is merged over the axis and the f32
p·v partials summed (``layers.attend_segment``), and the ring rolls
across the segments (``layers.roll_segments``).  Where the q heads are a
shard over that same axis ("model"; the kv heads are then whole, or the
layout is refused), q is first gathered over it, so that every rank
scores every head on its segment, and each rank keeps its own heads'
rows of the merged output for ``wo``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import sharding as shlib
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
    """(B, S, d) x (d, N, hd) -> (B, S, N, hd) in x's dtype (w's d a
    "data" shard on the activation-gathered route: ``layers.dense``)."""
    d, n, hd = w.shape
    out = layers.dense(x, w.reshape(d, n * hd))
    return out.reshape(*x.shape[:-1], n, hd)


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


def _out(p: Dict, o: torch.Tensor, x: torch.Tensor, tp=None
         ) -> torch.Tensor:
    """``wo`` over the heads ``o`` holds, in x's dtype; under tensor
    parallelism the ranks' f32 partials summed by *g* and rounded once."""
    B, S = o.shape[:2]
    H, hd, d = p["wo"].shape
    out = layers.row_parallel(o.reshape(B, S, H * hd),
                              p["wo"].reshape(H * hd, d), tp, x.shape[-1])
    return out if tp is None else shlib.reduce_from_model(out, tp, x.dtype)


def _parallel(p: Dict, cfg: ArchConfig, x: torch.Tensor):
    """``(p, x, tp)`` for a tensor-parallel block (``tp`` None: whole
    heads, ``p`` and ``x`` as given): x and every weight the rank holds
    whole through *f*."""
    tp = shlib.tp_for(p["wq"].shape[1], cfg.n_heads)
    if tp is None:
        return p, x, None
    kv_whole = p["wk"].shape[1] == cfg.n_kv_heads
    p = {k: shlib.copy_to_model(w, tp)
         if k in ("q_norm", "k_norm") or (kv_whole and k in ("wk", "wv"))
         else w for k, w in p.items()}
    return p, shlib.copy_to_model(x, tp), tp


def _local_kv(cfg: ArchConfig, tp, h_local: int, k: torch.Tensor,
              v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kv heads this rank's q heads read, from whole (B, T, K, D) k and
    v (``k``, ``v`` themselves when they are this rank's shard already):
    a contiguous slice when the local q heads cover whole GQA groups or
    lie in one, else one kv head per q head."""
    K = cfg.n_kv_heads
    if tp is None or k.shape[2] != K:
        return k, v
    group = cfg.n_heads // K
    h0 = tp.rank * h_local
    lo, hi = h0 // group, (h0 + h_local - 1) // group + 1
    if h_local % (hi - lo) == 0 and all(
            (h0 + j) // group == lo + j // (h_local // (hi - lo))
            for j in range(h_local)):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    idx = torch.tensor([(h0 + j) // group for j in range(h_local)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


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
    p, x, tp = _parallel(p, cfg, x)
    q, k, v = _qkv(p, cfg, x, positions)
    kq, vq = _local_kv(cfg, tp, q.shape[2], k, v)
    o = ops.flash_attention(q, kq, vq, causal=causal, window=window)
    out = _out(p, o, x, tp)
    if not return_cache:
        return out, None
    return out, KVCache(shlib.seq_segment(k), shlib.seq_segment(v))


def apply_decode(p: Dict, cfg: ArchConfig, x: torch.Tensor, cache: KVCache,
                 pos: int, *, window: int = 0
                 ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, d); pos: the new token's absolute
    position.  The cache holds the previous ``T`` entries (window-sized
    when sliding windows are active).  Returns the output and the rolled
    cache: the oldest entry out, the new one in (views of the joined
    tensors the attention read; the caller stores them)."""
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    p, x, tp = _parallel(p, cfg, x)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    seq = shlib.current_seq()
    if seq is None:
        k = torch.cat([cache.k, k_new], dim=1)
        v = torch.cat([cache.v, v_new], dim=1)
        o = layers.attend_one(q, *_local_kv(cfg, tp, q.shape[2], k, v))
        return _out(p, o, x, tp), KVCache(k[:, 1:], v[:, 1:])
    h = q.shape[2]
    every_head = tp is not None and seq.axis == "model"
    if every_head:
        q = shlib.gather_model(q, 2, tp)
        kv = (cache.k, cache.v, k_new, v_new)
    else:
        kv = (*_local_kv(cfg, tp, h, cache.k, cache.v),
              *_local_kv(cfg, tp, h, k_new, v_new))
    o = layers.attend_segment(q, *kv, seq)
    if every_head:
        o = o[:, :, tp.rank * h:(tp.rank + 1) * h]
    return _out(p, o, x, tp), KVCache(*layers.roll_segments(
        (cache.k, cache.v), (k_new, v_new), seq))


def init_cache_shape(cfg: ArchConfig, batch: int, cache_len: int
                     ) -> Tuple[Tuple[int, ...], Tuple]:
    """The canonical (shape, logical axes) of a layer's k or v cache (a
    rank of the production layout holds ``sharding.cache_extent`` of its
    kv heads and of its sequence)."""
    hd = cfg.resolved_head_dim
    shape = (batch, cache_len, cfg.n_kv_heads, hd)
    axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    return shape, axes

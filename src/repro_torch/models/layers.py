"""Shared neural-net layers (plain functions over parameter dicts).

Numerics policy (``repro.models.layers``): activations in the parameter
dtype; norms, softmax and matmul accumulation in f32.  Where the JAX package
asks a bf16 matmul for an f32 result (``preferred_element_type=f32``) and
keeps it in f32 (the SwiGLU gate and up projections, the time MLP's silu
input), the port takes the bf16 result of ``torch.matmul`` — accumulated in
f32, rounded once to bf16 — and upcasts it: the same to bf16 rounding, not
bitwise.  In f32 every product is an f32 matmul, as in the reference.

Under ``PerfConfig.policy_dtype="float32"`` on bf16 parameters the
activations are f32 and the weights bf16.  JAX's einsum promotes the pair
to f32; ``torch.matmul`` refuses mixed dtypes, so every product takes its
weight as ``w.to(x.dtype)``: the activation dtype, and the same tensor,
with no launch, when the dtypes already agree.

The LM head's logits (``chunked_ce_loss``, ``Backbone.logits``) follow the
same policy: the product runs in the activation dtype (a bf16 result,
accumulated in f32) and is upcast, so the log-sum-exp, the softmax and
the loss are f32 as in the reference, on logits rounded once to bf16.  An
f32 product would run at 151,655 vocabulary columns outside the tensor
cores (``internvl2-1b``).  Decode attention (``attend_one``) and the
cross-entropy stay plain PyTorch, as the reference computes them in jnp
outside any Pallas kernel.

Under tensor parallelism a row-parallel product (``wo``, ``w_down``,
``out_proj``, the experts' ``w_down``) is the rank's partial sum: it stays
f32 (``row_parallel``: a bf16 GEMM with an f32 output on the card and on
meta, f32 operands on the CPU, where the product of two bf16 values is
exact) and *g* sums the ranks' partials and rounds once, as the
reference's ``reduce_dtype`` accumulates; its gradients are the bf16
product's.  ``REPRO_BF16_REDUCE`` set (``reduce_dtype``, read at call
time as the reference reads it) rounds each rank's partial to bf16 once
and *g* sums the bf16 partials: half the bytes of each such all-reduce,
the reference's Megatron-style trade.  With no "model" group the switch
changes nothing: a whole product is rounded once either way.  On the
activation-gathered route (``sharding.current_rows``) a weight narrower
than its product's dim is this rank's "data" shard of it: ``dense``
(the contraction dim) and ``row_parallel`` given the canonical output
width run the product through ``sharding.rows_in`` / ``rows_out``, the
d-partials in ``reduce_dtype()`` as *g*'s.  With a decode cache's sequence split over a mesh axis
(``sharding.current_seq``) each rank scores its segment and the softmax
is merged over the axis (``merged_softmax``: the all-reduced max and sum
of exponentials, p rounded after the division as the reference rounds
it); ``roll_segments`` rolls the ring across the segments.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shlib
from repro_torch.models.params import P

F32 = torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> P:
    return P((d,), ("norm",), "ones")


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5,
            tp: Optional[shlib.TP] = None) -> torch.Tensor:
    """RMSNorm over the last dim.  With ``tp`` x (and ``w``) is this
    rank's slice of a dim split evenly over "model": the f32 sum of
    squares is summed over the ranks (``sharding.sum_over_model``) and
    divided by the whole width."""
    xf = x.to(F32)
    if tp is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        var = shlib.sum_over_model(torch.sum(xf * xf, dim=-1, keepdim=True),
                                   tp) / (x.shape[-1] * tp.size)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=F32, device=device)
                            / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: (..., S) integers."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)          # (D/2,)
    angles = positions.to(F32)[..., None] * freqs         # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Row-parallel products (f32 partial sums for g, or bf16 under the switch)
# ---------------------------------------------------------------------------

def reduce_dtype() -> torch.dtype:
    """The dtype a rank's row-parallel partial sum is handed to *g* in:
    bf16 when ``REPRO_BF16_REDUCE`` is set and non-empty, f32 otherwise
    (the reference's ``reduce_dtype``)."""
    return torch.bfloat16 if os.environ.get("REPRO_BF16_REDUCE") else F32


def f32_product(a: torch.Tensor, b: torch.Tensor, op=torch.mm
                ) -> torch.Tensor:
    """``op(a, b)`` (``torch.mm`` or ``torch.bmm``) of two operands of one
    dtype with an f32 result: the GEMM's own f32 output on the card and
    on meta, f32 operands on the CPU (no ``out_dtype`` there)."""
    if a.dtype == F32:
        return op(a, b)
    if a.device.type == "cpu":
        return op(a.to(F32), b.to(F32))
    return op(a, b, out_dtype=F32)


class _Carried(torch.autograd.Function):
    """The carrier of a row-parallel partial ``a @ w`` (a (..., K),
    w (K, N), one dtype; ``sharding.Partial``): saves a and w and returns
    zeros of the product's shape with no storage.  The backward is the
    product's in a's dtype, the two GEMMs ``torch.matmul`` runs for it."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        return torch.zeros((), dtype=a.dtype, device=a.device).expand(
            *a.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, grad):
        a, w = ctx.saved_tensors
        g = grad.reshape(-1, w.shape[1])
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = g.mm(w.t()).view(a.shape)
        if ctx.needs_input_grad[1]:
            dw = a.reshape(-1, a.shape[-1]).t().mm(g)
        return da, dw


def partial_product(a: torch.Tensor, b: torch.Tensor, op=torch.mm
                    ) -> torch.Tensor:
    """``op(a, b)`` as a rank's partial sum: f32 (``f32_product``), or
    rounded once to ``reduce_dtype()`` under ``REPRO_BF16_REDUCE``."""
    rd = reduce_dtype()
    if rd == F32:
        return f32_product(a, b, op)
    if a.dtype == rd:
        return op(a, b)
    return f32_product(a, b, op).to(rd)


def row_parallel(a: torch.Tensor, w: torch.Tensor, tp=None,
                 full: Optional[int] = None):
    """``a @ w`` (w cast to a's dtype): in a's dtype when whole (``tp``
    None); under tensor parallelism the rank's partial sum as a
    ``sharding.Partial``: the product in ``reduce_dtype()``
    (``partial_product``), computed when ``sharding.reduce_from_model``
    adds it, and its carrier.  ``full``: the canonical output width; a
    narrower ``w`` is this rank's "data" shard of its columns on the
    activation-gathered route (``sharding.rows_out``)."""
    w = w.to(a.dtype)
    rows = None if full is None else shlib.rows_for(w.shape[1], full)
    if rows is not None:
        if tp is None:
            return shlib.rows_out(a, w, rows)
        return shlib.Partial(
            lambda: shlib.rows_out_value(a, w, rows, partial_product),
            shlib.rows_out(a, w, rows, carry=True))
    if tp is None:
        return torch.matmul(a, w).to(a.dtype)
    return shlib.Partial(
        lambda: partial_product(a.reshape(-1, a.shape[-1]), w).view(
            *a.shape[:-1], w.shape[1]), _Carried.apply(a, w))


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` (w (K, N) cast to x's dtype) in x's dtype.  A ``w`` with
    fewer rows than x's K is this rank's "data" shard of the contraction
    dim on the activation-gathered route (``sharding.rows_in``): the
    d-partial in ``reduce_dtype()`` (f32 for f32 operands), summed onto
    this rank's rows and rounded once."""
    w = w.to(x.dtype)
    rows = shlib.rows_for(w.shape[0], x.shape[-1])
    if rows is None:
        return torch.matmul(x, w).to(x.dtype)
    return shlib.rows_in(x, w, rows, f32_product if x.dtype == F32
                         else partial_product)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_spec(d: int, f: int) -> dict:
    return {
        "w_gate": P((d, f), ("embed", "mlp")),
        "w_up": P((d, f), ("embed", "mlp")),
        "w_down": P((f, d), ("mlp", "embed_r")),
    }


# a row-wise step without gradients over a sequence longer than this, with
# no mesh, runs in pieces of this many tokens (``seq_pieces``): whole, its
# f32 intermediates are held at once (zamba2-2.7b's SwiGLU gate and up
# products, 21.5 GB each over long_500k's 524160 tokens, made its prefill's
# peak 120 GB)
SEQ_PIECE = 65536


def in_pieces(S: int) -> bool:
    """Whether a step over S tokens runs in pieces: no gradient is taken,
    no mesh is installed and S exceeds ``SEQ_PIECE``."""
    return (S > SEQ_PIECE and not torch.is_grad_enabled()
            and shlib.current_mesh() is None)


def seq_pieces(fn, S: int) -> torch.Tensor:
    """A step over S tokens whose every output token depends on its own
    neighbourhood alone, ``fn(s, m)`` giving the output's tokens
    [s, s + m) (B, m, ...): ``fn(0, S)``, or where ``in_pieces(S)`` a
    piece of ``SEQ_PIECE`` tokens at a time, each written into the
    output as it comes."""
    if not in_pieces(S):
        return fn(0, S)
    out = None
    for s in range(0, S, SEQ_PIECE):
        piece = fn(s, min(SEQ_PIECE, S - s))
        if out is None:
            out = piece.new_empty((piece.shape[0], S, *piece.shape[2:]))
        out[:, s:s + piece.shape[1]] = piece
        del piece
    return out


def mlp(p: dict, x: torch.Tensor, width: Optional[int] = None
        ) -> torch.Tensor:
    """SwiGLU.  ``width``: the canonical hidden width; a narrower
    ``w_gate`` is this rank's shard of the production layout, and the MLP
    runs tensor-parallel over "model": x through *f*, ``w_gate`` and
    ``w_up`` column-parallel, ``w_down`` row-parallel, its partial outputs
    summed by *g* (``repro_torch.sharding``).  A long sequence without
    gradients runs in pieces (``seq_pieces``)."""
    tp = None if width is None else shlib.tp_for(p["w_gate"].shape[1],
                                                 width)
    if tp is None:
        return seq_pieces(lambda s, m: swiglu(p, x[:, s:s + m]), x.shape[1])
    x = shlib.copy_to_model(x, tp)
    return shlib.reduce_from_model(swiglu(p, x, tp), tp, x.dtype)


def swiglu(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The SwiGLU product over the hidden dim ``p`` holds, in x's dtype:
    with a rank's shard of it (``tp``), that rank's partial output, a
    ``sharding.Partial`` (``row_parallel``)."""
    g = dense(x, p["w_gate"]).to(F32)
    u = dense(x, p["w_up"]).to(F32)
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return row_parallel(h, p["w_down"], tp, x.shape[-1])


# ---------------------------------------------------------------------------
# Attention math, plain version (the model routes attention through
# kernels.ops.flash_attention; this is the reference's jnp path, kept as a
# second plain version to hold the kernel's against)
# ---------------------------------------------------------------------------

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(Sq, Sk) additive bias. window>0 => sliding-window of that width."""
    dq = q_pos[:, None]
    dk = k_pos[None, :]
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= dk <= dq
    if window > 0:
        ok &= dk > dq - window
    zero = torch.zeros((), dtype=F32, device=q_pos.device)
    return torch.where(ok, zero, torch.full((), NEG_INF, dtype=F32,
                                            device=q_pos.device))


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_positions: Optional[torch.Tensor] = None,
                      k_positions: Optional[torch.Tensor] = None,
                      chunk_q: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Memory-bounded attention: a loop over query chunks.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0 (GQA).  Scores
    and softmax in f32; p is cast to q's dtype before the value product, as
    in the reference."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=q.device)
    if k_positions is None:
        k_positions = torch.arange(Sk, dtype=torch.int32, device=q.device)
    qg = q.reshape(B, Sq, K, G, D)
    kf, vf = k.to(F32), v.to(F32)

    def one_chunk(q_chunk: torch.Tensor, qpos_chunk: torch.Tensor):
        s = torch.einsum("bckgd,btkd->bckgt", q_chunk.to(F32), kf) * scale
        s = s + _mask_bias(qpos_chunk, k_positions, causal, window)[
            None, :, None, None, :]
        p = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bckgt,btkd->bckgd", p.to(F32), vf).to(q.dtype)

    outs = [one_chunk(qg[:, c:c + chunk_q], q_positions[c:c + chunk_q])
            for c in range(0, Sq, chunk_q)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dv)


def attend_one(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: Optional[float] = None) -> torch.Tensor:
    """One query token over every key of k, v: the reference's
    ``attention_decode`` once the cache and the new entry are joined
    (``attention.apply_decode`` joins them once and keeps the join as the
    rolled cache).

    q: (B, 1, H, D); k, v: (B, T, K, D); no mask (a decode cache holds
    only valid entries; a window is enforced by the cache's length).
    Scores, softmax and the value product in f32, p cast to q's dtype in
    between, as the reference's."""
    B, _, H, D = q.shape
    K = k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, K, H // K, D).to(F32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.to(F32)) * scale
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(F32), v.to(F32))
    return o.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


def merged_softmax(s: torch.Tensor, seq, dtype) -> torch.Tensor:
    """The softmax over the last dim of scores ``s`` (f32) whose entries
    are spread over the ranks of ``seq`` (a ``sharding.SeqGroup``, each
    rank its segment's): the max and the sum of exp(s - max) all-reduced
    over the group, p = exp(s - max) / sum rounded to ``dtype`` (where the
    reference rounds its softmax)."""
    m = shlib.all_reduce_max(s.amax(dim=-1, keepdim=True), seq.group)
    e = torch.exp(s - m)
    den = shlib.all_reduce_sum_(e.sum(dim=-1, keepdim=True), seq.group)
    return e.div_(den).to(dtype)


def attend_segment(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor, seq,
                   scale: Optional[float] = None) -> torch.Tensor:
    """:func:`attend_one` over a cache whose sequence is split over the
    ranks of ``seq``: q (B, 1, H, D) against this rank's segment k, v
    (B, T/n, K, D), and on the last rank (which stores it) the new entry
    k_new, v_new (B, 1, K, D) too, so every entry is scored once; the
    softmax merged over the group (:func:`merged_softmax`) and the f32
    partial p·v all-reduced and rounded once."""
    B, _, H, D = q.shape
    K, T = k.shape[2], k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, K, H // K, D).to(F32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.to(F32)) * scale
    last = seq.rank == seq.size - 1
    if last:
        s_new = torch.einsum("bkgd,bkd->bkg", qg, k_new[:, 0].to(F32))
        s = torch.cat([s, (s_new * scale)[..., None]], dim=-1)
    p = merged_softmax(s, seq, q.dtype).to(F32)
    o = torch.einsum("bkgt,btkd->bkgd", p[..., :T], v.to(F32))
    if last:
        o += p[..., T:] * v_new[:, 0].to(F32)[:, :, None, :]
    o = shlib.all_reduce_sum_(o, seq.group)
    return o.reshape(B, 1, H, v.shape[-1]).to(q.dtype)


def roll_segments(segs, news, seq):
    """The ring rolled one entry across the segments of ``seq``'s ranks:
    each of this rank's cache tensors ``segs`` (B, T/n, ...) without its
    first entry, followed by the next rank's first entry, or on the last
    rank by the new entry (``news``, (B, 1, ...) each).  One all-gather of
    the ranks' first entries, not of the caches."""
    B = segs[0].shape[0]
    firsts = torch.cat([t[:, :1].reshape(B, -1) for t in segs], dim=-1)
    every = shlib.gather_dim(firsts[None], 0, seq.group, seq.size)
    nxt = (torch.cat([t.reshape(B, -1) for t in news], dim=-1)
           if seq.rank == seq.size - 1 else every[seq.rank + 1])
    out, c = [], 0
    for t in segs:
        w = math.prod(t.shape[2:])
        out.append(torch.cat([t[:, 1:], nxt[:, c:c + w].view(
            B, 1, *t.shape[2:])], dim=1))
        c += w
    return tuple(out)


# ---------------------------------------------------------------------------
# Chunked cross-entropy (vocab can be 150k; never materialise full logits)
# ---------------------------------------------------------------------------

def _chunk_ce(h_c: torch.Tensor, y_c: torch.Tensor, w_vocab: torch.Tensor,
              tp=None) -> torch.Tensor:
    logits = dense(h_c, w_vocab).to(F32)
    if tp is not None:
        return _VocabParallelCE.apply(logits, y_c, tp)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
    return torch.sum(logz - gold)


class _VocabParallelCE(torch.autograd.Function):
    """sum(logz - gold) over tokens from this rank's vocabulary columns of
    the logits: the max and the sum of exponentials all-reduced over
    "model", the gold logit from the rank that owns it (the others add
    0).  Backward: softmax minus the one-hot of the label, on this rank's
    columns."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        v_local = logits.shape[-1]
        m = shlib.all_reduce_max(logits.amax(dim=-1), tp.group)
        e = torch.exp(logits - m[..., None])
        s = shlib.all_reduce_sum_(e.sum(dim=-1), tp.group)
        ids = labels.long() - tp.rank * v_local
        own = (ids >= 0) & (ids < v_local)
        ids = torch.where(own, ids, torch.zeros_like(ids))
        gold = torch.gather(logits, -1, ids[..., None])[..., 0]
        gold = shlib.all_reduce_sum_(torch.where(own, gold,
                                                 torch.zeros_like(gold)),
                                     tp.group)
        ctx.save_for_backward(e.div_(s[..., None]), ids, own)
        return torch.sum(m + torch.log(s) - gold)

    @staticmethod
    def backward(ctx, grad):
        p, ids, own = ctx.saved_tensors
        g = p.clone()
        g.scatter_add_(-1, ids[..., None], -own[..., None].to(g.dtype))
        return g.mul_(grad), None, None


def chunked_ce_loss(hidden: torch.Tensor, w_vocab: torch.Tensor,
                    labels: torch.Tensor, *, chunk: int = 512,
                    vocab_size: Optional[int] = None) -> torch.Tensor:
    """hidden: (B, S, d); w_vocab: (d, V); labels: (B, S) integers.

    Loops over sequence chunks so the (tokens, V) logit block peaks at
    B*chunk*V instead of B*S*V; with grad enabled each chunk runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward (the
    reference's ``jax.checkpoint``).  A ragged tail (S not a multiple of
    ``chunk``) is one more, shorter chunk.  ``vocab_size``: the canonical
    V; a narrower ``w_vocab`` is this rank's column shard of the
    production layout, and the CE is vocab-parallel over "model" (hidden
    through *f*).  Returns the f32 mean."""
    B, S, _ = hidden.shape
    tp = (None if vocab_size is None
          else shlib.tp_for(w_vocab.shape[1], vocab_size))
    if tp is not None:
        hidden = shlib.copy_to_model(hidden, tp)
    chunk = min(chunk, S)
    ckpt = torch.is_grad_enabled()
    total = None
    for c in range(0, S, chunk):
        args = (hidden[:, c:c + chunk], labels[:, c:c + chunk], w_vocab, tp)
        part = (checkpoint(_chunk_ce, *args, use_reentrant=False,
                           preserve_rng_state=False) if ckpt
                else _chunk_ce(*args))
        total = part if total is None else total + part
    return total / (B * S)


# ---------------------------------------------------------------------------
# Time embedding (flow / DiT conditioning)
# ---------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 1e4
                       ) -> torch.Tensor:
    """t: (B,) in [0,1] -> (B, dim) sinusoidal features (f32)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=F32, device=t.device) / half)
    args = t.to(F32)[:, None] * freqs[None, :] * 1000.0
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb

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
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.params import P

F32 = torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> P:
    return P((d,), ("norm",), "ones")


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
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
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_spec(d: int, f: int) -> dict:
    return {
        "w_gate": P((d, f), ("embed", "mlp")),
        "w_up": P((d, f), ("embed", "mlp")),
        "w_down": P((f, d), ("mlp", "embed_r")),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, p["w_gate"].to(x.dtype)).to(F32)
    u = torch.matmul(x, p["w_up"].to(x.dtype)).to(F32)
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return torch.matmul(h, p["w_down"].to(x.dtype)).to(x.dtype)


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


# ---------------------------------------------------------------------------
# Chunked cross-entropy (vocab can be 150k; never materialise full logits)
# ---------------------------------------------------------------------------

def _chunk_ce(h_c: torch.Tensor, y_c: torch.Tensor, w_vocab: torch.Tensor
              ) -> torch.Tensor:
    logits = torch.matmul(h_c, w_vocab.to(h_c.dtype)).to(F32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def chunked_ce_loss(hidden: torch.Tensor, w_vocab: torch.Tensor,
                    labels: torch.Tensor, *, chunk: int = 512
                    ) -> torch.Tensor:
    """hidden: (B, S, d); w_vocab: (d, V); labels: (B, S) integers.

    Loops over sequence chunks so the (tokens, V) logit block peaks at
    B*chunk*V instead of B*S*V; with grad enabled each chunk runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward (the
    reference's ``jax.checkpoint``).  A ragged tail (S not a multiple of
    ``chunk``) is one more, shorter chunk.  Returns the f32 mean."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    ckpt = torch.is_grad_enabled()
    total = None
    for c in range(0, S, chunk):
        args = (hidden[:, c:c + chunk], labels[:, c:c + chunk], w_vocab)
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

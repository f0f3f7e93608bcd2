"""Mixture-of-Experts FFN (grok-1: 8e top-2; deepseek-v2: 2 shared + 160e
top-6), the port of ``repro.models.moe``.

Groups are sequences (the whole batch for a single-token input).  A router
in f32 (the bf16 activations and router weights are upcast before the
product, as the reference asks its einsum for an f32 result) picks each
token's top-k experts; the gates are renormalised over the top-k and
clipped at 1e-9.  Each expert holds ``C = capacity(T)`` slots per group;
an assignment's rank within its expert, in token order, is its drop
priority, and a dropped assignment contributes zero.

Dispatch is slot-based, as in the reference, and deterministic: each slot
*gathers* the assignment that fills it (``index_select``; empty slots read
a zero row), where the reference scatter-adds into a (G, E·C + 1, d)
buffer whose extra row takes every dropped assignment.  Kept slots are
unique, so the two fill the same slots, and neither the forward nor the
backward adds two values into one kept row: the served latents are bitwise
on rerun.  The expert products stay ``torch.bmm`` (the reference leaves
them to XLA, outside any Pallas kernel), batched over a chunk of experts
whose gate/up transient stays under ``_CHUNK_ELEMS`` elements (15 of
deepseek's experts at 4 x 4608 tokens; one at a time at grok-1's width,
where one expert's (4 x 2308, 32768) gate is 605 MB in bf16), inside one
autograd Function from the rows to the gated results
(``_RoutedExperts``), whose backward runs each chunk's products again.
The gate and up products are rounded to the activation dtype and upcast,
as ``layers.mlp`` does (the same to bf16 rounding as the reference's f32
result, not bitwise).

Modes (``moe_mode``): "tensor" (default) and "ep_model" run the slot
dispatch (they differ in the reference only in the partitioner's layout;
here only in the logical axes of the expert tables, which the
``PartitionPlan`` reads), "dense" computes every expert on every token and
mixes by dense gates.

``apply`` returns ``(out, aux)`` with the Switch load-balance loss and the
router z-loss.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.models import layers
from repro_torch.models.params import P

F32 = torch.float32
# the largest (experts x rows x d_ff) gate/up product of one expert chunk
_CHUNK_ELEMS = 1 << 25


def moe_mode(cfg: ArchConfig) -> str:
    """tensor (default) | ep_model | dense — see module docstring."""
    return os.environ.get("REPRO_MOE_MODE", cfg.moe.sharding or "tensor")


def spec(cfg: ArchConfig) -> Dict:
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.expert_d_ff
    if moe_mode(cfg) == "ep_model":
        ex, fa = "experts_mdl", "moe_f"
    else:
        ex, fa = "experts", "mlp"
    s = {
        "router": P((d, E), ("embed", None), "small"),
        "w_gate": P((E, d, f), (ex, "moe_in", fa)),
        "w_up": P((E, d, f), (ex, "moe_in", fa)),
        "w_down": P((E, f, d), (ex, fa, "moe_out")),
    }
    if m.n_shared_experts:
        s["shared"] = layers.mlp_spec(d, m.n_shared_experts * f)
    return s


def capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(2.0 * tokens_per_group * m.top_k / m.n_experts) + 1
    return max(4, -(-c // 4) * 4)  # round up to multiple of 4


def _slots(idx: torch.Tensor, E: int, C: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """idx: (G, T, k) expert assignments -> (slot (G, Tk), keep (G, Tk)).

    slot ∈ [0, E·C) for kept assignments, E·C (overflow) for drops;
    rank-within-expert in token order is the drop priority (the
    reference's ``_slots_one_group`` over each group).  The reference
    takes the rank from a cumulative sum over a (Tk, E) one-hot; a stable
    sort by expert gives the same ranks in O(Tk log Tk): an assignment's
    rank is its place in the sorted order less its expert's first
    place."""
    G, T, k = idx.shape
    flat_e = idx.reshape(G, T * k)
    order = torch.sort(flat_e, dim=1, stable=True).indices
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, E), dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    first = torch.cumsum(counts, dim=1) - counts          # (G, E)
    place = torch.arange(T * k, device=idx.device).expand(G, -1)
    rank = torch.empty_like(flat_e).scatter_(
        1, order, place - torch.gather(first, 1, sorted_e))
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank,
                       torch.full_like(rank, E * C))
    return slot, keep


def _swiglu(xb: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor
            ) -> Tuple[torch.Tensor, ...]:
    """A chunk of experts' gate and up products in f32 (rounded to the
    activation dtype first, as ``layers.mlp``) and h = silu(g) u in the
    activation dtype."""
    g = torch.bmm(xb, wg).to(F32)
    u = torch.bmm(xb, wu).to(F32)
    return g, u, (torch.nn.functional.silu(g) * u).to(xb.dtype)


class _RoutedExperts(torch.autograd.Function):
    """The routed experts of one MoE call, from the assignments' rows to
    their gated results: for each expert's slots the rows that fill them
    are gathered (``fill``), the expert's SwiGLU runs on them, and each
    slot's result, times its assignment's gate, is written to that
    assignment's row; a dropped assignment's row is zero.

    xs (A + 1, d): the A = G·T·k assignments' input rows (token-major, k
    a token) and a zero row; fill (E, M) long: the row that fills each of
    the expert's M = G·C slots, A for an empty one; w (A,): each
    assignment's gate (zero if dropped).  Returns (A / k, d): each token's
    k gated results summed in a fixed order.  Experts run a chunk of
    ``step`` at a time.

    The reference scatters the rows into a (G, E, C, d) buffer and gathers
    the results back; here neither the buffer nor the (E, M, d) results
    exist whole.  Each chunk's slots gather their rows, and each result row
    is written once, to its own assignment (``index_copy_``: kept slots are
    unique, so no two values meet in a kept row and the output is bitwise
    the same on rerun; the empty slots all write one extra row that is
    dropped).  The backward keeps xs, fill, w and the weights only and runs
    each chunk's products again, so one chunk's f32 gate and up values live
    at a time; the tables' gradients are accumulated chunk by chunk into
    one tensor each.  At deepseek-v2-236b's width over 4 x 4608 tokens
    this keeps the buffer, the results, their gradients and all 160
    experts' f32 values (each 2 to 7.5 GB) off the card, which one MoE
    layer's training needs beside its 50 GiB of state."""

    @staticmethod
    def forward(ctx, xs, fill, w, wg, wu, wd, k, step):
        A = xs.shape[0] - 1
        w1 = torch.cat([w, w.new_zeros(1)])
        out = xs.new_zeros((A + 1, xs.shape[1]))
        for e0 in range(0, fill.shape[0], step):
            c = slice(e0, e0 + step)
            rows = fill[c].reshape(-1)
            xb = xs.index_select(0, rows).view(*fill[c].shape, -1)
            y = torch.bmm(_swiglu(xb, wg[c], wu[c])[-1], wd[c])
            out.index_copy_(0, rows, y.view(rows.shape[0], -1)
                            * w1.index_select(0, rows)[:, None])
        ctx.save_for_backward(xs, fill, w1, wg, wu, wd)
        ctx.k, ctx.step = k, step
        return out[:A].view(A // k, k, -1).sum(dim=1)

    @staticmethod
    def backward(ctx, dtok):
        xs, fill, w1, wg, wu, wd = ctx.saved_tensors
        A, dt = xs.shape[0] - 1, xs.dtype
        dxs = torch.zeros_like(xs)
        dw = torch.zeros_like(w1)
        dwg, dwu, dwd = (torch.zeros_like(t) for t in (wg, wu, wd))
        for e0 in range(0, fill.shape[0], ctx.step):
            c = slice(e0, e0 + ctx.step)
            rows = fill[c].reshape(-1)
            n_e = fill[c].shape[0]
            xb = xs.index_select(0, rows).view(*fill[c].shape, -1)
            g, u, h = _swiglu(xb, wg[c], wu[c])
            y = torch.bmm(h, wd[c]).view(rows.shape[0], -1)
            # the gradient of y w at each slot: its token's (an empty
            # slot's, A, reads token 0 and is zeroed)
            live = rows < A
            dslot = dtok.index_select(0, rows.clamp(max=A - 1) // ctx.k) \
                * live[:, None].to(dt)
            dw.index_copy_(0, rows, (dslot * y).sum(-1))
            dy = (dslot * w1.index_select(0, rows)[:, None]).view(
                n_e, -1, y.shape[-1])
            del y, dslot
            dwd[c].baddbmm_(h.transpose(1, 2), dy)
            dh = torch.bmm(dy, wd[c].transpose(1, 2)).to(F32)
            du = (dh * torch.nn.functional.silu(g)).to(dt)
            # silu'(g) = sig (1 + g (1 - sig)), as torch's silu backward
            sig = torch.sigmoid(g)
            dg = (dh * u * sig * (1 + g * (1 - sig))).to(dt)
            del g, u, sig, h, dh, dy
            dwg[c].baddbmm_(xb.transpose(1, 2), dg)
            dwu[c].baddbmm_(xb.transpose(1, 2), du)
            dxb = torch.bmm(dg, wg[c].transpose(1, 2))
            dxb += torch.bmm(du, wu[c].transpose(1, 2))
            # kept slots add into distinct rows; the empty ones into row A,
            # which is dropped
            dxs.index_add_(0, rows, dxb.view(rows.shape[0], -1))
        dxs[A].zero_()
        return (dxs, None, dw[:A], dwg, dwu, dwd, None, None)


def _slot_dispatch(p: Dict, cfg: ArchConfig, xg: torch.Tensor,
                   gates: torch.Tensor, idx: torch.Tensor, C: int
                   ) -> torch.Tensor:
    G, T, d = xg.shape
    m = cfg.moe
    E, k, f = m.n_experts, m.top_k, m.expert_d_ff
    A = G * T * k
    slot, keep = _slots(idx, E, C)
    dev = xg.device
    # every assignment's row, then one zero row for the empty slots
    xs = xg.new_empty((A + 1, d))
    xs[:-1].view(G, T, k, d).copy_(xg[:, :, None, :])
    xs[-1].zero_()
    # which assignment fills each slot: kept slots are unique; the
    # overflow column takes every drop and is discarded; laid out (E, G, C)
    # so that each expert's slots are contiguous
    fill = torch.full((G, E * C + 1), A, dtype=torch.long, device=dev)
    fill.scatter_(1, slot, torch.arange(A, device=dev).view(G, T * k))
    fill = fill[:, :E * C].view(G, E, C).transpose(0, 1).reshape(E, G * C)
    w = (gates.reshape(A).to(xg.dtype) * keep.reshape(A))
    step = max(1, _CHUNK_ELEMS // max(G * C * f, 1))
    out = _RoutedExperts.apply(xs, fill, w, *(
        p[n].to(xg.dtype) for n in ("w_gate", "w_up", "w_down")), k, step)
    return out.view(G, T, d)


def _dense_all_experts(p: Dict, cfg: ArchConfig, xg: torch.Tensor,
                       gates: torch.Tensor, idx: torch.Tensor
                       ) -> torch.Tensor:
    """Small-E mode: every expert on every token, mixed by dense gates
    (the gates folded into h before one (E·f -> d) contraction)."""
    G, T, d = xg.shape
    E, f = cfg.moe.n_experts, cfg.moe.expert_d_ff
    dt = xg.dtype
    gates_dense = torch.zeros((G, T, E), dtype=dt, device=xg.device)
    gates_dense.scatter_(2, idx, gates.to(dt))
    g = torch.einsum("gtd,edf->gtef", xg, p["w_gate"].to(dt)).to(F32)
    u = torch.einsum("gtd,edf->gtef", xg, p["w_up"].to(dt)).to(F32)
    h = (torch.nn.functional.silu(g) * u).to(dt)
    h = h * gates_dense[..., None]
    return torch.matmul(h.reshape(G, T, E * f),
                        p["w_down"].to(dt).reshape(E * f, d)).to(dt)


def route(p: Dict, cfg: ArchConfig, xg: torch.Tensor
          ) -> Tuple[torch.Tensor, ...]:
    """The router: (logits (G, T, E) f32, probs, gates (G, T, k)
    renormalised over the top-k, idx (G, T, k) expert assignments)."""
    logits = torch.matmul(xg.to(F32), p["router"].to(F32))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def apply(p: Dict, cfg: ArchConfig, x: torch.Tensor
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux).  Groups = sequences (the whole batch for
    single-token inputs)."""
    m = cfg.moe
    B, S, d = x.shape
    xg = x.reshape(1, B, d) if S == 1 else x
    G, T, _ = xg.shape
    E = m.n_experts
    C = capacity(T, cfg)

    logits, probs, gates, idx = route(p, cfg, xg)

    if moe_mode(cfg) == "dense":
        out = _dense_all_experts(p, cfg, xg, gates, idx)
    else:
        out = _slot_dispatch(p, cfg, xg, gates, idx, C)
    if S == 1:
        out = out.reshape(B, S, d)

    if m.n_shared_experts:
        out = out + layers.mlp(p["shared"], x)

    # auxiliary losses (Switch-style load balance + router z-loss)
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(idx, E).to(F32).sum(2).mean(dim=(0, 1))
    aux = {
        "moe_lb_loss": E * torch.sum(me * ce) * m.aux_loss_coef,
        "moe_z_loss": (torch.logsumexp(logits, dim=-1) ** 2).mean()
        * m.router_z_coef,
    }
    return out, aux

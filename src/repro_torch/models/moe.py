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
dispatch (they differ in the logical axes of the expert tables, which the
layouts read, and so in which shard of them a rank holds), "dense"
computes every expert on every token and mixes by dense gates.

Under the production layout of ``repro_torch.sharding`` the routed
experts run over "model" in one of two ways, read from the shapes of the
tables a rank holds (``w_gate`` narrower than the config in either its
expert dim or its hidden dim):

* tensor parallel (tensor and dense modes): each rank holds every
  expert's ``f / mp`` slice of ``w_gate``, ``w_up`` and ``w_down`` and
  runs its slice of each SwiGLU;
* expert parallel (``ep_model``, where the axis divides E): rank r holds
  experts [r·E/mp, (r+1)·E/mp) at the whole ``expert_d_ff`` and runs
  those experts' slots alone.  The rows are replicated over "model" (the
  batch splits over "data" only), so a rank fills its experts' slots from
  the rows it holds: no row is sent to another rank, and no (G, E, C, d)
  buffer or gather of results exists.

Either way the rank combines its partial results with the gates as one
device does, and one *g* (``sharding.reduce_from_model``) adds the ranks'
partial (G, T, d), with the shared experts' partial (their hidden dim
sharded over "model") in the same sum.  The router and the slot table
run over all E experts on every rank, so the drop order is the whole
group's.  The partials stay f32 until that sum, which is rounded once:
the routed experts' ``w_down`` products, their gated sum over the top-k
and the dense route's one contraction in f32 (``layers.f32_product``,
``layers.row_parallel``); under ``REPRO_BF16_REDUCE`` each slot's product
is rounded to bf16 and multiplied by its gate there, as the reference's
slot route does, the top-k summed, and the bf16 partial is summed by *g*
(``layers.reduce_dtype``).  The rows enter the experts through *f*
(``sharding.copy_to_model``), and so do the gates: they multiply partial
results, so each rank's gradient into them is partial.  The router reads
x itself, and the auxiliary losses, computed the same on every rank, send
their gradient to it once.

On the activation-gathered route (``sharding.rows_for``: the tables'
``moe_in`` / ``moe_out`` dims a "data" shard at use, the reference's
``gathered_param_rules`` layout in tensor mode) each rank still routes
its own rows; each chunk of experts takes this rank's d-columns of every
rank's slot rows by one all-to-all, sums the gate and up d-partials back
onto its slots, gathers every rank's h for the down product and sends
each slot's columns home (``_swiglu``, ``_down``; the backward the
mirror, the tables' gradients divided by the data ranks).  The router,
the shared experts and the dense mode's products go through
``layers.dense`` / ``row_parallel``.

``apply`` returns ``(out, aux)`` with the Switch load-balance loss and the
router z-loss.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import torch

from repro_torch import sharding as shlib
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


def _swiglu(xb: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            route=None) -> Tuple[torch.Tensor, ...]:
    """A chunk of experts' gate and up products in f32 (rounded to the
    activation dtype first, as ``layers.mlp``) and h = silu(g) u in the
    activation dtype.  On the activation-gathered route (``route``: the
    tables' d a "data" shard) this rank's d-columns of every rank's slot
    rows arrive by one all-to-all (``sharding.rows_away``: a slot buffer
    is mostly empty slots at a few tokens a group, and the whole rows
    would be n times the bytes), are multiplied, and the d-partials
    (``layers.partial_product``) summed back onto this rank's slots."""
    if route is None:
        g = torch.bmm(xb, wg).to(F32)
        u = torch.bmm(xb, wu).to(F32)
    else:
        xs = shlib.rows_away(xb, route)
        g, u = (shlib.rows_sum(layers.partial_product(xs, w, torch.bmm),
                               route).to(xb.dtype).to(F32) for w in (wg, wu))
    return g, u, (torch.nn.functional.silu(g) * u).to(xb.dtype)


def _down(h: torch.Tensor, wd: torch.Tensor, route, prod=torch.bmm
          ) -> torch.Tensor:
    """A chunk of experts' down products ``prod(h, wd)`` (E_c, M, d); on
    the route (``wd``'s d a "data" shard) every rank's slot rows times
    this rank's columns, each slot's columns sent home."""
    if route is None:
        return prod(h, wd)
    return shlib.rows_home(prod(shlib.rows_gather(h, route), wd), route)


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
    layer's training needs beside its 50 GiB of state.

    ``part`` (a rank's partial sums under tensor or expert parallelism:
    the dtype *g* sums them in, ``layers.reduce_dtype``): the call returns
    them with a carrier (``sharding.Partial``), so the gradient arrives in
    the activation dtype.  In f32 the products, their gates and each
    token's sum stay f32 until *g*; in bf16 each slot's product is
    rounded to bf16 (``layers.partial_product``) and multiplied by its
    gate there, and each token's sum is rounded to bf16 once.  Each
    expert's gated results are added straight into their tokens' rows of
    an f32 (A / k, d) output (``index_add_``, expert by expert: an
    expert's slots hold distinct tokens, so no two values meet in a row
    and the sum's order is the experts', the same on rerun; an empty
    slot's value is zero and is added to a row of its own index, where it
    changes nothing), so the (A + 1, d) buffer is not held."""

    @staticmethod
    def forward(ctx, xs, fill, w, wg, wu, wd, k, step, part=None,
                route=None):
        A = xs.shape[0] - 1
        w1 = torch.cat([w, w.new_zeros(1)])
        if part is not None:
            out = xs.new_zeros((A // k, xs.shape[1]), dtype=F32)
            spread = torch.arange(fill.shape[1],
                                  device=fill.device) % (A // k)
        else:
            out = xs.new_zeros((A + 1, xs.shape[1]))
        for e0 in range(0, fill.shape[0], step):
            c = slice(e0, e0 + step)
            rows = fill[c].reshape(-1)
            xb = xs.index_select(0, rows).view(*fill[c].shape, -1)
            h = _swiglu(xb, wg[c], wu[c], route)[-1]
            if part is None:
                y = _down(h, wd[c], route)
                out.index_copy_(0, rows, y.view(rows.shape[0], -1)
                                * w1.index_select(0, rows)[:, None])
                continue
            y = _down(h, wd[c], route, lambda a, b: layers.partial_product(
                a, b, torch.bmm))
            del xb
            y.mul_(w1.index_select(0, rows).view(*fill[c].shape, 1))
            tok = torch.where(fill[c] < A, fill[c] // k, spread)
            for e in range(y.shape[0]):
                out.index_add_(0, tok[e], y[e].to(F32))
            del y
        ctx.save_for_backward(xs, fill, w1, wg, wu, wd)
        ctx.k, ctx.step, ctx.route = k, step, route
        if part is None:
            return out[:A].view(A // k, k, -1).sum(dim=1)
        out = out.to(part)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(out)
        return out, shlib.carrier(out, xs.dtype)

    @staticmethod
    def backward(ctx, *grads):
        dtok = grads[-1]     # the output's, or an f32 forward's carrier's
        if dtok is None:
            return (None,) * 10
        xs, fill, w1, wg, wu, wd = ctx.saved_tensors
        A, dt, route = xs.shape[0] - 1, xs.dtype, ctx.route
        # the route's tables' gradients: sums over every rank's slots,
        # divided by the ranks when their rows differ
        mean = route.size if route is not None and route.split else 1
        dxs = torch.zeros_like(xs)
        dw = torch.zeros_like(w1)
        dwg, dwu, dwd = (torch.zeros_like(t) for t in (wg, wu, wd))
        for e0 in range(0, fill.shape[0], ctx.step):
            c = slice(e0, e0 + ctx.step)
            rows = fill[c].reshape(-1)
            n_e = fill[c].shape[0]
            xb = xs.index_select(0, rows).view(*fill[c].shape, -1)
            g, u, h = _swiglu(xb, wg[c], wu[c], route)
            y = _down(h, wd[c], route).view(rows.shape[0], -1)
            # the gradient of y w at each slot: its token's (an empty
            # slot's, A, reads token 0 and is zeroed)
            live = rows < A
            dslot = dtok.index_select(0, rows.clamp(max=A - 1) // ctx.k) \
                * live[:, None].to(dt)
            dw.index_copy_(0, rows, (dslot * y).sum(-1))
            dy = (dslot * w1.index_select(0, rows)[:, None]).view(
                n_e, -1, y.shape[-1])
            del y, dslot
            if route is not None:   # every rank's slots, this rank's d
                dy = shlib.rows_away(dy, route).contiguous()
                h = shlib.rows_gather(h, route)
            dwd[c].baddbmm_(h.transpose(1, 2), dy, alpha=1 / mean)
            dh = torch.bmm(dy, wd[c].transpose(1, 2)).to(F32)
            if route is not None:
                dh = shlib.rows_sum(dh, route)
            du = (dh * torch.nn.functional.silu(g)).to(dt)
            # silu'(g) = sig (1 + g (1 - sig)), as torch's silu backward
            sig = torch.sigmoid(g)
            dg = (dh * u * sig * (1 + g * (1 - sig))).to(dt)
            del g, u, sig, h, dh, dy
            if route is not None:
                xb = shlib.rows_away(xb, route)
                dg, du = (shlib.rows_gather(t, route) for t in (dg, du))
            dwg[c].baddbmm_(xb.transpose(1, 2), dg, alpha=1 / mean)
            dwu[c].baddbmm_(xb.transpose(1, 2), du, alpha=1 / mean)
            dxb = torch.bmm(dg, wg[c].transpose(1, 2))
            dxb += torch.bmm(du, wu[c].transpose(1, 2))
            if route is not None:
                dxb = shlib.rows_home(dxb, route)
            # kept slots add into distinct rows; the empty ones into row A,
            # which is dropped
            dxs.index_add_(0, rows, dxb.view(rows.shape[0], -1))
        dxs[A].zero_()
        return (dxs, None, dw[:A], dwg, dwu, dwd, None, None, None, None)


def _slot_dispatch(p: Dict, cfg: ArchConfig, xg: torch.Tensor,
                   gates: torch.Tensor, idx: torch.Tensor, C: int,
                   tp=None) -> torch.Tensor:
    """The routed experts' gated results (G, T, d) over the experts and
    the hidden dim ``w_gate`` holds (a rank's partial sum under tensor or
    expert parallelism, ``tp``: a ``sharding.Partial`` in
    ``layers.reduce_dtype()``).  The slots are those of all E experts;
    a rank holding E / mp experts (rank r: [r·E/mp, (r+1)·E/mp)) fills
    theirs.  A chunk holds as many experts as on one device, whose
    gate/up transient the whole ``expert_d_ff`` sizes: a rank's narrower
    one would take more experts a chunk, and its d-wide rows and results
    would grow with them."""
    G, T, d = xg.shape
    m = cfg.moe
    E, k, f = m.n_experts, m.top_k, m.expert_d_ff
    mine = p["w_gate"].shape[0]
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
    fill = fill[:, :E * C].view(G, E, C).transpose(0, 1)
    if mine != E:    # expert parallel: this rank's experts' slots
        fill = fill[tp.rank * mine:(tp.rank + 1) * mine]
    fill = fill.reshape(mine, G * C)
    w = (gates.reshape(A).to(xg.dtype) * keep.reshape(A))
    step = max(1, _CHUNK_ELEMS // max(G * C * f, 1))
    out = _RoutedExperts.apply(xs, fill, w, *(
        p[n].to(xg.dtype) for n in ("w_gate", "w_up", "w_down")), k, step,
        None if tp is None else layers.reduce_dtype(),
        shlib.rows_for(p["w_gate"].shape[1], d))
    if tp is not None:
        return shlib.Partial(*out).reshape(G, T, d)
    return out.view(G, T, d)


def _dense_all_experts(p: Dict, cfg: ArchConfig, xg: torch.Tensor,
                       gates: torch.Tensor, idx: torch.Tensor, tp=None
                       ) -> torch.Tensor:
    """Small-E mode: every expert on every token, mixed by dense gates
    (the gates folded into h before one (E·f -> d) contraction), over the
    hidden dim ``w_gate`` holds (the contraction a rank's f32 partial
    under tensor parallelism, ``tp``)."""
    G, T, d = xg.shape
    E, f = cfg.moe.n_experts, p["w_gate"].shape[-1]
    dt = xg.dtype
    gates_dense = torch.zeros((G, T, E), dtype=dt, device=xg.device)
    gates_dense.scatter_(2, idx, gates.to(dt))
    if shlib.rows_for(p["w_gate"].shape[1], d) is None:
        g, u = (torch.einsum("gtd,edf->gtef", xg, p[n].to(dt)).to(F32)
                for n in ("w_gate", "w_up"))
    else:   # the tables' d a "data" shard: one (d / n, E·f) product each
        g, u = (layers.dense(xg, p[n].transpose(0, 1).reshape(
            -1, E * f)).view(G, T, E, f).to(F32) for n in ("w_gate", "w_up"))
    h = (torch.nn.functional.silu(g) * u).to(dt)
    h = h * gates_dense[..., None]
    return layers.row_parallel(h.reshape(G, T, E * f),
                               p["w_down"].reshape(E * f, -1), tp, d)


def route(p: Dict, cfg: ArchConfig, xg: torch.Tensor
          ) -> Tuple[torch.Tensor, ...]:
    """The router: (logits (G, T, E) f32, probs, gates (G, T, k)
    renormalised over the top-k, idx (G, T, k) expert assignments)."""
    logits = layers.dense(xg.to(F32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gates, idx


def apply(p: Dict, cfg: ArchConfig, x: torch.Tensor, aux: bool = True
          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux).  Groups = sequences (the whole batch for
    single-token inputs).  ``aux=False`` returns no auxiliary losses (the
    callers that drop them).  On a mesh whose "data" ranks hold
    different rows the load-balance loss's two means are taken over every
    rank's rows (``sharding.mean_over_data``), as the reference's means
    over its sharded batch are: the loss is a product of two means, so
    the ranks' own losses would not average to it."""
    m = cfg.moe
    B, S, d = x.shape
    xg = x.reshape(1, B, d) if S == 1 else x
    G, T, _ = xg.shape
    E = m.n_experts
    C = capacity(T, cfg)

    logits, probs, gates, idx = route(p, cfg, xg)
    # a shard of the tables' expert dim (expert parallel) or of their
    # hidden dim (tensor parallel)
    wg = p["w_gate"]
    tp = shlib.tp_for(wg.shape[0] * wg.shape[-1], E * m.expert_d_ff)
    if tp is not None:
        xg, gates = (shlib.copy_to_model(t, tp) for t in (xg, gates))

    if moe_mode(cfg) == "dense":
        out = _dense_all_experts(p, cfg, xg, gates, idx, tp)
    else:
        out = _slot_dispatch(p, cfg, xg, gates, idx, C, tp)
    if S == 1:
        out = out.reshape(B, S, d)

    shared = None
    if m.n_shared_experts:
        width = m.n_shared_experts * m.expert_d_ff
        if tp is not None and shlib.tp_for(p["shared"]["w_gate"].shape[1],
                                           width):
            # this rank's slice of the shared experts, in the same g
            out = (out, layers.swiglu(p["shared"], xg.view(B, S, d), tp))
        else:   # whole on every rank, added after g
            def shared():
                return layers.mlp(p["shared"], x, width)
    if tp is not None:
        out = shlib.reduce_from_model(out, tp, x.dtype)
    if shared is not None:
        out = out + shared()

    if not aux:
        return out, {}
    # auxiliary losses (Switch-style load balance + router z-loss)
    me = shlib.mean_over_data(probs.mean(dim=(0, 1)))
    ce = shlib.mean_over_data(torch.nn.functional.one_hot(idx, E).to(F32)
                              .sum(2).mean(dim=(0, 1)))
    return out, {
        "moe_lb_loss": E * torch.sum(me * ce) * m.aux_loss_coef,
        "moe_z_loss": (torch.logsumexp(logits, dim=-1) ** 2).mean()
        * m.router_z_coef,
    }

"""Step functions for the LM role of every architecture (``repro.models.tasks``):
train (next-token), prefill, and one-token decode.  The flow-RL steps (the
paper's pipeline) live in ``repro_torch.core.trainers`` and reuse the same
backbones.

On a CUDA device every attention of the train step and the prefill runs the
hand-written attention kernels (``kernels.ops.flash_attention``, and its
backward under the loss), and the ``ssm`` / ``hybrid`` families' scans the
hand-written ``ssd_scan`` forward and backward; the prefill's final scan
state becomes the ``SSMCache`` state.  Decode attention, ``ssd_decode_step``,
MLA's absorbed decode and the chunked cross-entropy are plain PyTorch, as
the reference computes them in jnp outside any Pallas kernel.

Unlike the reference's pure functions, the steps update their state in
place, as the port's trainers do: the train step writes the parameters and
AdamW moments (``TrainState`` comes back holding the same tensors), the
decode step writes the rolled caches into the caches it was given.

Randomness is injected: threefry and Philox draws never match, so
``init_params`` draws from a ``torch.Generator`` on the target device or
takes the reference's parameters as numpy arrays (``params.from_numpy``),
and ``synthetic_batch`` draws from a numpy seed or takes the arrays.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import optim, registry
from repro_torch import sharding as shlib
from repro_torch.config import ArchConfig, InputShape, OptimConfig
from repro_torch.models import params as params_lib
from repro_torch.models.backbone import Backbone
from repro_torch.models.layers import chunked_ce_loss

F32 = torch.float32


class TrainState(NamedTuple):
    params: Any
    opt: optim.AdamWState


# ---------------------------------------------------------------------------
# Shape policy
# ---------------------------------------------------------------------------

def effective_window(cfg: ArchConfig, shape: InputShape) -> int:
    """Sliding-window policy: full attention everywhere except long_500k,
    where attention archs switch to their sliding-window variant (the
    sub-quadratic requirement); SSM archs have no attention at all."""
    if cfg.family == "ssm":
        return 0
    if shape.seq_len > 65536 and shape.kind in ("decode", "prefill"):
        return cfg.window or 8192
    return 0


def effective_cache_len(cfg: ArchConfig, shape: InputShape) -> int:
    w = effective_window(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                dtype=torch.bfloat16, device="cuda", *, arrays=None) -> Dict:
    """The backbone's parameters: drawn on ``device`` from ``generator``
    (which lives there), or ``arrays`` (the reference's tree as numpy
    arrays) carried across, cast to ``dtype`` (None: bit for bit)."""
    if arrays is not None:
        return params_lib.from_numpy(arrays, device, dtype)
    return params_lib.init(Backbone(cfg).spec(), generator, dtype, device)


def init_caches(cfg: ArchConfig, batch: int, cache_len: int,
                dtype=torch.bfloat16, device="cuda"):
    """Zero caches of ``cache_len`` entries (``Backbone.init_caches``: the
    SSM state in f32)."""
    return Backbone(cfg).init_caches(batch, cache_len, dtype, device)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, opt_cfg: OptimConfig, *,
                    window: int = 0, remat: bool = True):
    """``train_step(state, batch) -> (state, metrics)``: next-token CE
    (plus the MoE auxiliary losses) over the tokens after the frontend
    prefix, its gradient (each block checkpointed under ``remat``), clip
    by global norm and one step of the registry's optimizer at the
    schedule's rate.  Metrics: ``loss``, ``ce``, ``grad_norm``, ``lr`` and
    the auxiliary losses, as 0-d tensors on the device (no host sync).
    Leaves the loss does not reach (``frontend_proj`` without a prefix,
    ``dit``'s ``ada``) get zero gradients, as ``jax.grad`` gives them.
    Under an installed gather context (``sharding.param_gather(mesh)``,
    the batch split over "data", params laid out by the ``PartitionPlan``)
    the gradients, loss and CE are averaged over the mesh as the trainers
    average them (``_mesh_grads``) before the clip.
    ``train_step.loss_fn(params, batch) -> (total, ce, aux)`` is the
    differentiated loss alone, for callers that take its gradient
    themselves."""
    model = Backbone(cfg)
    lr_fn = optim.make_schedule(opt_cfg)
    # the registry's optimizer, as the RL trainers use it: one OptimConfig
    # means the same thing on both training paths
    optimizer = registry.build("optimizer", opt_cfg.optimizer)
    n_pre = model.n_prefix

    def loss_fn(p: Dict, batch: Dict[str, torch.Tensor]):
        x = model.embed_inputs(p, batch["tokens"], batch.get("prefix_embed"))
        hidden, _, aux = model.forward_embeds(
            p, x, causal=True, window=window, remat=remat, return_aux=True)
        if n_pre:
            hidden = hidden[:, n_pre:]
        ce = chunked_ce_loss(hidden, model.head_matrix(p), batch["labels"])
        total = ce + sum(aux.values()) if aux else ce
        return total, ce, aux

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state.params
        leaves = [p for _, p in params_lib.leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
        try:
            total, ce, aux = loss_fn(params, batch)
            total.backward()
        finally:
            for p in leaves:
                p.requires_grad_(False)
        grads = _grads(params)
        mesh = shlib.current_mesh()
        sharded, mgroup = frozenset(), None
        if mesh is not None:
            grads, sharded, mgroup = _mesh_grads(grads, mesh, model.spec())
            total, ce = (shlib.all_reduce_mean(t.detach(),
                                               mesh.get_group("data"),
                                               int(mesh.size(0)))
                         for t in (total, ce))
        _, gnorm = optim.clip_by_global_norm(
            grads, opt_cfg.grad_clip, sharded=sharded,
            group=mgroup if sharded else None)
        step = int(state.opt.step) + 1
        scalars = optim.step_scalars(leaves[0].device)
        optim.write_step_scalars(scalars, opt_cfg, step, lr_fn(step - 1))
        optimizer.apply(params, grads, state.opt, opt_cfg, scalars)
        state.opt.step.fill_(step)
        metrics = {"loss": total.detach(), "ce": ce.detach(),
                   "grad_norm": gnorm, "lr": scalars.lr}
        metrics.update({k: v.detach() for k, v in aux.items()})
        return TrainState(params, state.opt), metrics

    train_step.loss_fn = loss_fn
    return train_step


def _mesh_grads(grads: Dict, mesh, spec) -> Tuple[Dict, frozenset, Any]:
    """The gradients on a (data, model) mesh, as the trainers take them:
    each averaged over "data" (f32), a leaf the ``PartitionPlan`` keeps
    whole averaged over "model" too (a sharded leaf's gradient was
    reduce-scattered by its gather).  Returns (grads, the sharded leaves'
    paths, the "model" group) for the clip."""
    dp, mp = int(mesh.size(0)), int(mesh.size(1))
    dgroup, mgroup = mesh.get_group("data"), mesh.get_group("model")
    specs = dict(params_lib.leaves(spec))
    out: Dict = {}
    sharded = set()
    for path, g in params_lib.leaves(grads):
        s = specs[path]
        g = shlib.all_reduce_mean(g, dgroup, dp)
        if params_lib.model_shard_dim(s.shape, s.axes, mp) is not None:
            sharded.add(path)
        elif mp > 1:
            g = shlib.all_reduce_mean(g, mgroup, mp)
        params_lib._set(out, path, g)
    return out, frozenset(sharded), mgroup


def _grads(tree: Dict) -> Dict:
    """Each leaf's ``.grad`` (zeros where the loss does not reach it),
    taken off the leaf."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _grads(v)
        else:
            out[k] = v.grad if v.grad is not None else torch.zeros_like(v)
            v.grad = None
    return out


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ArchConfig, *, window: int = 0):
    """``prefill_step(params, batch) -> (last_logits (B, V) f32, caches)``:
    the causal forward over ``[prefix; tokens]`` with every layer's cache
    (``Backbone.forward_embeds(return_caches=True)``)."""
    model = Backbone(cfg)

    @torch.no_grad()
    def prefill_step(p: Dict, batch: Dict[str, torch.Tensor]):
        x = model.embed_inputs(p, batch["tokens"], batch.get("prefix_embed"))
        hidden, caches, _ = model.forward_embeds(
            p, x, causal=True, window=window, return_caches=True)
        return model.logits(p, hidden[:, -1]), caches

    return prefill_step


def make_decode_step(cfg: ArchConfig, *, window: int = 0):
    """``decode_step(params, caches, token, pos) -> (logits (B, V) f32,
    caches)``: token (B, 1) integers, pos the token's absolute position
    (the frontend prefix counts).  The rolled caches are written into
    ``caches``."""
    model = Backbone(cfg)

    @torch.no_grad()
    def decode_step(p: Dict, caches, token: torch.Tensor, pos):
        x = model.embed_inputs(p, token)
        hidden, caches = model.decode_embeds(p, x, caches, int(pos),
                                             window=window)
        return model.logits(p, hidden[:, -1]), caches

    return decode_step


# ---------------------------------------------------------------------------
# Synthetic batches (smoke tests / examples)
# ---------------------------------------------------------------------------

def synthetic_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 0,
                    device="cuda", *, tokens=None, prefix_embed=None
                    ) -> Dict[str, torch.Tensor]:
    """``tokens`` (B, S) int32 uniform over the vocabulary, ``labels`` the
    tokens rolled left by one, and for a frontend arch ``prefix_embed``
    (B, n_tokens, embed_dim) bf16 of f32 normals: drawn from numpy's
    ``default_rng(seed)``, or the injected arrays."""
    rng = np.random.default_rng(seed)
    toks = (np.asarray(tokens, np.int32) if tokens is not None else
            rng.integers(0, cfg.vocab_size, (batch, seq), dtype=np.int32))
    out = {"tokens": torch.from_numpy(toks).to(device),
           "labels": torch.from_numpy(np.roll(toks, -1, axis=1)).to(device)}
    fe = cfg.frontend
    if fe.kind != "none":
        pe = (np.asarray(prefix_embed, np.float32)
              if prefix_embed is not None else rng.standard_normal(
                  (batch, fe.n_tokens, fe.embed_dim)).astype(np.float32))
        out["prefix_embed"] = torch.from_numpy(pe).to(device).to(
            torch.bfloat16)
    return out

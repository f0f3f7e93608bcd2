"""Backbone of the port: every family of ``repro.models.backbone`` (``dit``,
``dense``, ``vlm``, ``audio``, ``moe``, ``ssm``, ``hybrid``).

The spec is the reference's whole tree (embedding, final norm, LM head,
the frontend families' ``frontend_proj`` and the stacked blocks), so
parameter trees cross between the packages key for key.
``forward_embeds`` runs the blocks as a Python loop over slices of the
stacked leaves where the reference scans; the slices are views, so
gradients reach the stacked leaves.  ``dit`` with a conditioning vector
runs the bidirectional adaLN-zero blocks (the flow adapter's call); without
one (the LM task path) its plain blocks, ``ada`` unused, as the reference.
``dense``, ``vlm`` and ``audio`` run the pre-norm blocks ``[ln, attention,
ln, SwiGLU]`` with no modulation; the frontend families differ only in the
``frontend_proj`` leaf ``(embed_dim, d_model)`` that ``embed_inputs``
applies to a prefix of frontend embeddings (the flow adapter never calls
it, so on the flow path the leaf gets no gradient).  ``ssm`` runs the
Mamba-2 blocks ``[ln, SSD]`` (causal by construction).  ``hybrid``
(Zamba2) stacks the Mamba-2 blocks twice, ``(n_layers // attn_every,
attn_every, ...)`` with the outer axis named "groups", and after each
group's SSM blocks applies the one *shared* ``[ln, attention, ln,
SwiGLU]`` block (``shared_attn``, unstacked), so its gradient is the sum
over its ``n_layers // attn_every`` sites.  The shared attention runs
causally with the caller's ``window``: the flow adapter passes 0, as the
reference does.  ``moe`` (grok-1, DeepSeek-V2) runs the dense family's
blocks with the SwiGLU replaced by the mixture of experts
(``models/moe.py``), after ``first_k_dense`` plain blocks stacked apart as
``dense_blocks``; with ``cfg.mla`` set the attention is the latent
attention of ``models/mla.py``.

Two callers, two costs.  The flow adapter calls ``forward_embeds`` for the
hidden states alone: no cache is allocated and the MoE blocks' auxiliary
losses are not computed (the reference's adapter computes and drops
them).  The LM task path (``models/tasks.py``) asks for them:
``return_aux`` sums each MoE block's losses over the layers (the loss is
CE + aux; on a mesh their means span every "data" rank's rows),
``return_caches``
returns each layer's KV / latent / SSM cache stacked as the reference's
scans stack them (leading layer dims; the hybrid's ``(ssm (groups, every,
...), attn (groups, ...))``, the MoE family's ``(dense, moe)`` pair when it
has dense first layers).  Each layer's entries are written into tensors
preallocated from ``cache_specs``, so a 32k-token prefill never holds a
cache twice.  ``decode_embeds`` runs one token per sequence against such
caches and writes the rolled caches back into them (the reference returns
new arrays; at ``decode_32k``'s 51.5 GB a second copy would not fit one
card).  Decode runs in plain PyTorch: no Pallas kernel covers it.

On a mesh with a "model" axis each block first lays out its slice of the
sharded leaves (``repro_torch.sharding.constrain_params``, where the
reference constrains each scan slice to the gathered layout; each
against its own unstacked spec: dense or MoE); the hybrid's shared block
is laid out at each of its sites, as the reference's ``_gather`` does
inside its scan.  In the trainers' layout every leaf is gathered whole,
so the block's kernels see whole weights.  Under the production rules
the "data" shards are gathered (on the activation-gathered route kept,
each product gathering its rows over "data" instead: every product goes
through ``layers.dense`` / ``row_parallel``, the embedding through
``sharding.lookup_rows``) and the "model" shards kept: attention,
MLA, the SwiGLU MLP and the MoE family's routed and shared experts run
tensor-parallel (``attention``, ``mla``, ``layers.mlp``, ``moe``), as do
the embedding (each rank looks up its vocabulary rows, the others' tokens
masked, the sum taken over "model"), the LM head and the CE
(``layers.chunked_ce_loss``); the serving steps gather the logits over
"model" before they return.  The Mamba-2 blocks run tensor-parallel over
their SSD heads (``ssm``) where the "model" axis divides the heads and
the state; under ``ep_model`` each rank runs its E / mp routed experts
at their whole hidden dim (expert parallel, ``moe``); the routed experts
under ``ep_model`` where the axis does not divide E, and a Mamba-2 block
the axis does not divide, are gathered whole
(``sharding.GATHERED_WHOLE``, named per block by ``_parts``); the decode
caches hold this rank's kv
heads, and its SSD heads' states and conv channels
(``sharding.cache_extent``; MLA's latent cache has none), and where the
rules split a cache's sequence (``cache_seq``: the reference's rule,
``launch/specs.cache_rules``) this rank's contiguous segment of every
attention and latent cache: the prefill writes its segment of the whole
cache it computed, and the decode merges the segments' attention and
rolls the ring across them (``attention``, ``mla``).

``remat=True`` (``PerfConfig.remat="block"``, and the LM train step's
default) runs each block call (each group of the hybrid: the reference's
``jax.checkpoint`` wraps its group body) under ``torch.utils.checkpoint``
(non-reentrant) when grad is enabled: the backward keeps each unit's
inputs only and runs its forward again, kernels included, as the
reference's ``jax.checkpoint`` around its scan body does, the gather
included (a second all-gather).  The blocks draw nothing, so the RNG
state is not stashed.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shlib
from repro_torch.config import FAMILIES, ArchConfig
from repro_torch.models import attention, layers, mla, moe, ssm
from repro_torch.models.params import P, stack

F32 = torch.float32


def _attn_block_spec(cfg: ArchConfig, ffn: str = "mlp") -> Dict:
    d = cfg.d_model
    s = {
        "ln1": layers.rmsnorm_spec(d),
        "attn": mla.spec(cfg) if cfg.mla else attention.spec(cfg),
        "ln2": layers.rmsnorm_spec(d),
        "ffn": (moe.spec(cfg) if ffn == "moe"
                else layers.mlp_spec(d, cfg.d_ff)),
    }
    if cfg.family == "dit":
        # adaLN-zero: cond vector -> 6 modulation params per block
        s["ada"] = P((d, 6 * d), ("embed", None), "zeros")
    return s


def _ssm_block_spec(cfg: ArchConfig) -> Dict:
    return {"ln": layers.rmsnorm_spec(cfg.d_model), "ssm": ssm.spec(cfg)}


def _parts(cfg: ArchConfig, spec: Dict, mp: int = 1):
    """The ``GATHERED_WHOLE`` names of a block spec's parts that do not
    run tensor-parallel over a "model" axis of ``mp`` ranks
    (``sharding.constrain_params``' ``parts``)."""
    parts: Dict = {}
    if "ssm" in spec and mp > 1 and not ssm.splits(cfg, mp):
        parts["ssm"] = "ssm_undivided"
    if ("router" in spec.get("ffn", {}) and mp > 1
            and moe.moe_mode(cfg) == "ep_model" and cfg.moe.n_experts % mp):
        parts["ffn"] = {k: "experts_undivided"
                        for k in ("w_gate", "w_up", "w_down")}
    return parts or None


def _unbind(tree: Dict, n: int, axes: int = 1) -> List[Dict]:
    """The n per-layer slices of a tree stacked over its first ``axes``
    dims (2 for the hybrid's (groups, attn_every) stack), as views in
    row-major layer order.  Unbinding each leaf once (instead of indexing it
    once per layer) gives the backward one stack of the layers' gradients
    per leaf rather than a full-size zero-filled gradient for every
    layer."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n, axes) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree.flatten(0, axes - 1), 0))


def _is_spec_leaf(node) -> bool:
    """A ``(shape, logical_axes)`` leaf of a cache spec tree."""
    return (isinstance(node, tuple) and not hasattr(node, "_fields")
            and len(node) == 2 and isinstance(node[0], tuple)
            and all(isinstance(d, int) for d in node[0]))


def map_cache_spec(fn: Callable, node, name: Optional[str] = None):
    """``fn(leaf, field_name)`` over each ``(shape, axes)`` leaf of a cache
    spec tree (``Backbone.cache_specs``), keeping its structure: the
    caches' NamedTuples and the hybrid's / MoE family's pairs."""
    if hasattr(node, "_fields"):
        return type(node)(*(map_cache_spec(fn, v, f)
                            for f, v in zip(node._fields, node)))
    if _is_spec_leaf(node):
        return fn(node, name)
    return tuple(map_cache_spec(fn, v, name) for v in node)


def _index(tree, i):
    """Each tensor of a cache tree indexed by ``i`` along its leading dim
    (views), keeping the structure."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_index(v, i) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_index(v, i) for v in tree)
    return tree[i]


@torch.no_grad()
def _write(dst, src) -> None:
    """Copy a layer's cache ``src`` into its preallocated slot ``dst``
    (detached: a cache is never part of a loss's graph)."""
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _write(d, s)
    else:
        dst.copy_(src)


class Backbone:
    def __init__(self, cfg: ArchConfig):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown backbone family {cfg.family!r}; "
                             f"families: {FAMILIES}")
        self.cfg = cfg
        self.n_prefix = cfg.frontend.n_tokens
        # the unstacked block spec: a layer slice's canonical shapes and
        # logical axes, for the per-layer gather
        self._block_spec = (_ssm_block_spec(cfg)
                            if cfg.family in ("ssm", "hybrid")
                            else _attn_block_spec(cfg, "moe")
                            if cfg.family == "moe" else _attn_block_spec(cfg))
        self._first_dense = cfg.moe.first_k_dense if cfg.family == "moe" else 0
        if self._first_dense:
            self._dense_spec = _attn_block_spec(cfg)
        if cfg.family == "hybrid":
            self._every = cfg.hybrid.attn_every
            self._groups = cfg.n_layers // self._every
            self._shared_spec = _attn_block_spec(cfg)
        self._top_spec = None
        if self._first_dense:
            self._dense_parts = _parts(cfg, self._dense_spec)

    def spec(self) -> Dict:
        cfg = self.cfg
        d = cfg.d_model
        s: Dict[str, Any] = {
            "embed": P((cfg.vocab_size, d), ("vocab", "embed"), "small"),
            "final_norm": layers.rmsnorm_spec(d),
        }
        if cfg.family == "hybrid":
            inner = stack(self._block_spec, self._every, None)
            s["blocks"] = stack(inner, self._groups, "groups")
            s["shared_attn"] = self._shared_spec
        else:
            if self._first_dense:
                s["dense_blocks"] = stack(self._dense_spec, self._first_dense)
            s["blocks"] = stack(self._block_spec,
                                cfg.n_layers - self._first_dense)
        if not cfg.tie_embeddings:
            s["lm_head"] = P((d, cfg.vocab_size), ("embed", "vocab"))
        if cfg.frontend.kind != "none":
            s["frontend_proj"] = P((cfg.frontend.embed_dim, d),
                                   (None, "embed"))
        return s

    def _own(self, params: Dict, key: str) -> torch.Tensor:
        """A top-level leaf (embedding, LM head, frontend projection),
        laid out for use: gathered whole on a "model" axis, or under the
        production rules its "data" shard gathered (the vocabulary stays
        sharded over "model")."""
        if shlib.current_mesh() is None:
            return params[key]
        if self._top_spec is None:
            self._top_spec = self.spec()
        return shlib.constrain_params({key: params[key]},
                                      {key: self._top_spec[key]})[key]

    # ----------------------------------------------------------- blocks
    def _attn_block(self, p: Dict, x: torch.Tensor, slot=None, *,
                    causal: bool, window: int, positions: torch.Tensor,
                    cond: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """The adaLN-zero DiT block, modulated by ``cond`` (B, d)."""
        cfg = self.cfg
        mod = layers.dense(cond, p["ada"]).to(x.dtype)
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mod, 6, dim=-1)
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        h = h * (1 + sc_a[:, None]) + sh_a[:, None]
        a_out, cache = attention.apply_full(
            p["attn"], cfg, h, causal=causal, window=window,
            positions=positions, return_cache=slot is not None)
        if slot is not None:
            _write(slot, cache)
        x = x + g_a[:, None] * a_out
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        h = h * (1 + sc_m[:, None]) + sh_m[:, None]
        return x + g_m[:, None] * layers.mlp(p["ffn"], h, cfg.d_ff), {}

    def _dense_block(self, p: Dict, x: torch.Tensor, slot=None, *,
                     causal: bool, window: int, positions: torch.Tensor,
                     ffn: str = "mlp", aux: bool = False
                     ) -> Tuple[torch.Tensor, Dict]:
        """[ln, attention, ln, FFN]: the dense and frontend families'
        block, the hybrid's shared block, the MoE family's (MLA attention
        with ``cfg.mla``; ``ffn="moe"``: the mixture of experts, whose
        auxiliary losses it returns with ``aux``) and ``dit``'s
        unmodulated block.  With a cache ``slot`` the layer's cache is
        written into it."""
        cfg = self.cfg
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        attn_fn = mla.apply_full if cfg.mla else attention.apply_full
        a_out, cache = attn_fn(p["attn"], cfg, h, causal=causal,
                               window=window, positions=positions,
                               return_cache=slot is not None)
        if slot is not None:
            _write(slot, cache)
        x = x + a_out
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if ffn == "moe":
            f_out, losses = moe.apply(p["ffn"], cfg, h, aux)
            return x + f_out, losses
        return x + layers.mlp(p["ffn"], h, cfg.d_ff), {}

    def _ssm_block(self, p: Dict, x: torch.Tensor, slot=None
                   ) -> Tuple[torch.Tensor, Dict]:
        h = layers.rmsnorm(p["ln"], x, self.cfg.norm_eps)
        out, cache = ssm.apply_full(p["ssm"], self.cfg, h,
                                    return_cache=slot is not None)
        if slot is not None:
            _write(slot, cache)
        return x + out, {}

    def _attn_block_decode(self, p: Dict, x: torch.Tensor, slot, pos: int,
                           window: int, ffn: str = "mlp") -> torch.Tensor:
        """``_dense_block`` for one token against a cache ``slot``, its
        rolled cache written back; ``ffn`` as there (aux dropped)."""
        cfg = self.cfg
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        dec = mla.apply_decode if cfg.mla else attention.apply_decode
        a_out, cache = dec(p["attn"], cfg, h, slot, pos, window=window)
        _write(slot, cache)
        x = x + a_out
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if ffn == "moe":
            return x + moe.apply(p["ffn"], cfg, h, aux=False)[0]
        return x + layers.mlp(p["ffn"], h, cfg.d_ff)

    def _ssm_block_decode(self, p: Dict, x: torch.Tensor, slot
                          ) -> torch.Tensor:
        h = layers.rmsnorm(p["ln"], x, self.cfg.norm_eps)
        out, cache = ssm.apply_decode(p["ssm"], self.cfg, h, slot)
        _write(slot, cache)
        return x + out

    # -------------------------------------------------------- embedding
    def embed_inputs(self, params: Dict, tokens: torch.Tensor,
                     prefix_embed: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Token embeddings (B, S, d), after the frontend prefix
        ``prefix_embed`` (B, n_prefix, embed_dim) projected by
        ``frontend_proj`` when given: (B, n_prefix + S, d)."""
        w = self._own(params, "embed")
        d = self.cfg.d_model
        tp = shlib.tp_for(w.shape[0], self.cfg.vocab_size)

        def lookup(tokens, w):
            if tp is None:
                return torch.nn.functional.embedding(tokens.long(), w)
            ids = tokens.long() - tp.rank * w.shape[0]
            own = (ids >= 0) & (ids < w.shape[0])
            x = torch.nn.functional.embedding(
                torch.where(own, ids, torch.zeros_like(ids)), w)
            return shlib.reduce_from_model(
                x.masked_fill(~own[..., None], 0), tp)

        rows = shlib.rows_for(w.shape[1], d)
        x = (lookup(tokens, w) if rows is None
             else shlib.lookup_rows(tokens, w, rows, lookup))
        if prefix_embed is not None:
            pe = layers.row_parallel(prefix_embed.to(x.dtype),
                                     self._own(params, "frontend_proj"),
                                     None, d)
            x = torch.cat([pe, x], dim=1)
        return x

    def head_matrix(self, params: Dict) -> torch.Tensor:
        """(d, V): the LM head, or the embedding's transpose when tied."""
        if self.cfg.tie_embeddings:
            return self._own(params, "embed").T
        return self._own(params, "lm_head")

    def logits(self, params: Dict, hidden: torch.Tensor) -> torch.Tensor:
        """f32 logits of the product in the activation dtype
        (``layers``' numerics policy), over the whole vocabulary (a
        vocab-parallel head's columns gathered over "model")."""
        head = self.head_matrix(params)
        out = layers.dense(hidden, head).to(F32)
        tp = shlib.tp_for(head.shape[1], self.cfg.vocab_size)
        return out if tp is None else shlib.gather_model(out, -1, tp)

    # ---------------------------------------------------- full sequence
    def forward_embeds(self, params: Dict, x: torch.Tensor, *,
                       causal: bool = True, window: int = 0,
                       cond: Optional[torch.Tensor] = None,
                       remat: bool = False, return_caches: bool = False,
                       return_aux: bool = False):
        """Run all blocks over embedded inputs x: (B, S, d).

        With neither ``return_caches`` nor ``return_aux`` (the flow
        adapter's call) returns the normed hidden states alone; with
        either (the LM task path) returns ``(hidden, caches or None, aux)``
        as the reference does, ``aux`` the MoE losses summed over the
        layers (empty for the other families).  ``dit`` with the adaLN
        conditioning vector ``cond`` (B, d) runs its modulated blocks,
        without it its plain blocks; ``ssm`` is causal whatever ``causal``
        says.  ``remat`` checkpoints each block, each group of the hybrid
        (module docstring)."""
        cfg = self.cfg
        fam = cfg.family
        mesh, rules = shlib.current_mesh(), shlib.current_rules()
        block_parts = _parts(cfg, self._block_spec,
                             shlib.axis_size(mesh, "model"))
        caches = (self.init_caches(x.shape[0], x.shape[1], x.dtype,
                                   x.device) if return_caches else None)
        if fam != "ssm":
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)
            kw = dict(causal=causal, window=window, positions=positions)
        if fam in ("ssm", "hybrid"):
            block = self._ssm_block
        elif fam == "dit" and cond is not None:
            block = functools.partial(self._attn_block, cond=cond, **kw)
        else:
            block = functools.partial(self._dense_block, **kw)
            if fam == "moe":
                dense_block, block = block, functools.partial(
                    self._dense_block, ffn="moe", aux=return_aux, **kw)

        def run(p, x, slot=None, spec=self._block_spec, block=block,
                parts=block_parts):
            return block(shlib.constrain_params(p, spec, mesh, rules, parts),
                         x, slot)

        if fam == "hybrid":
            shared = functools.partial(self._dense_block, **kw)

            def run_group(ps, p_shared, x, slot=None):
                for j, p in enumerate(ps):
                    x, _ = run(p, x, None if slot is None
                               else _index(slot[0], j))
                return shared(shlib.constrain_params(
                    p_shared, self._shared_spec, mesh, rules), x,
                    None if slot is None else slot[1])

            every = self._every
            slices = _unbind(params["blocks"], self._groups * every, axes=2)
            units = [(run_group, (slices[i:i + every], params["shared_attn"]),
                      _index(caches, i // every))
                     for i in range(0, len(slices), every)]
        else:
            units = []
            if self._first_dense:
                caches_d, caches_m = caches or (None, None)
                run_dense = functools.partial(run, spec=self._dense_spec,
                                              block=dense_block,
                                              parts=self._dense_parts)
                units = [(run_dense, (p,), _index(caches_d, i))
                         for i, p in enumerate(_unbind(
                             params["dense_blocks"], self._first_dense))]
            else:
                caches_m = caches
            units += [(run, (p,), _index(caches_m, i)) for i, p in enumerate(
                _unbind(params["blocks"], cfg.n_layers - self._first_dense))]
        remat = remat and torch.is_grad_enabled()
        aux_tot: Dict[str, torch.Tensor] = {}
        for fn, args, slot in units:
            if remat:
                x, aux = checkpoint(fn, *args, x, slot, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = fn(*args, x, slot)
            if return_aux:
                for k, v in aux.items():
                    aux_tot[k] = aux_tot[k] + v if k in aux_tot else v
        x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        if return_caches or return_aux:
            return x, caches, aux_tot
        return x

    # ---------------------------------------------------------- decode
    @torch.no_grad()
    def decode_embeds(self, params: Dict, x: torch.Tensor, caches, pos: int,
                      *, window: int = 0) -> Tuple[torch.Tensor, Any]:
        """One-token step. x: (B, 1, d); caches as returned by prefill /
        ``init_caches``; pos: the new token's absolute position.  Each
        layer's rolled cache is written back into ``caches``, which are
        returned with the normed hidden states."""
        cfg = self.cfg
        fam = cfg.family
        mesh, rules = shlib.current_mesh(), shlib.current_rules()
        block_parts = _parts(cfg, self._block_spec,
                             shlib.axis_size(mesh, "model"))

        def gathered(p, spec, parts=None):
            return shlib.constrain_params(p, spec, mesh, rules, parts)

        if fam in ("ssm", "hybrid"):
            n = cfg.n_layers
            ps = _unbind(params["blocks"], n, axes=2 if fam == "hybrid"
                         else 1)
            every = self._every if fam == "hybrid" else n
            for i, p in enumerate(ps):
                slot = (_index(_index(caches[0], i // every), i % every)
                        if fam == "hybrid" else _index(caches, i))
                x = self._ssm_block_decode(
                    gathered(p, self._block_spec, block_parts), x, slot)
                if fam == "hybrid" and i % every == every - 1:
                    x = self._attn_block_decode(
                        gathered(params["shared_attn"], self._shared_spec),
                        x, _index(caches[1], i // every), pos, window)
        else:
            units = []
            if self._first_dense:
                caches_d, caches_m = caches
                units = [(p, self._dense_spec, self._dense_parts,
                          _index(caches_d, i), "mlp")
                         for i, p in enumerate(_unbind(
                             params["dense_blocks"], self._first_dense))]
            else:
                caches_m = caches
            ffn = "moe" if fam == "moe" else "mlp"
            units += [(p, self._block_spec, block_parts,
                       _index(caches_m, i), ffn)
                      for i, p in enumerate(_unbind(
                          params["blocks"], cfg.n_layers - self._first_dense))]
            for p, spec, parts, slot, ffn in units:
                x = self._attn_block_decode(gathered(p, spec, parts), x, slot,
                                            pos, window, ffn)
        return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps), caches

    # -------------------------------------------------------- cache specs
    def cache_specs(self, batch: int, cache_len: int) -> Any:
        """Tree of (shape, logical_axes) matching the decode cache
        structure (the reference's, for zeros-init)."""
        cfg = self.cfg
        fam = cfg.family

        def attn_cache_spec(lead: Tuple[int, ...] = ()):
            la = ("layers",) * len(lead)
            if cfg.mla:
                shp = mla.init_cache_shapes(cfg, batch, cache_len)
                return mla.MLACache(
                    c_kv=(lead + shp["c_kv"][0], la + shp["c_kv"][1]),
                    k_rope=(lead + shp["k_rope"][0], la + shp["k_rope"][1]))
            shape, axes = attention.init_cache_shape(cfg, batch, cache_len)
            return attention.KVCache(k=(lead + shape, la + axes),
                                     v=(lead + shape, la + axes))

        def ssm_cache_spec(lead: Tuple[int, ...] = ()):
            la = ("layers",) * len(lead)
            shp = ssm.init_cache_shapes(cfg, batch)
            return ssm.SSMCache(
                conv=(lead + shp["conv"][0], la + shp["conv"][1]),
                state=(lead + shp["state"][0], la + shp["state"][1]))

        if fam == "ssm":
            return ssm_cache_spec((cfg.n_layers,))
        if fam == "hybrid":
            return (ssm_cache_spec((self._groups, self._every)),
                    attn_cache_spec((self._groups,)))
        if self._first_dense:
            fk = self._first_dense
            return (attn_cache_spec((fk,)),
                    attn_cache_spec((cfg.n_layers - fk,)))
        return attn_cache_spec((cfg.n_layers,))

    def init_caches(self, batch: int, cache_len: int, dtype, device) -> Any:
        """Zero caches of ``cache_specs`` on ``device``: attention and
        latent entries and the SSM conv window in ``dtype``, the SSM state
        in f32 (the scan's and the recurrence's state dtype; the
        reference's zeros take ``dtype`` and turn f32 at its first
        decode).  Under the production rules the kv heads are this rank's
        (``sharding.cache_extent``), and so are the SSD heads and the conv
        channels where the Mamba-2 blocks run tensor-parallel, and the
        sequence where the rules split it (``cache_seq``)."""
        tp = shlib.current_tp()
        split = {"kv_heads", "cache_seq"}
        if self.cfg.family in ("ssm", "hybrid") and tp is not None and \
                ssm.splits(self.cfg, tp.size):
            split |= {"inner", "ssm_heads"}

        def leaf(sa, name):
            shape = tuple(shlib.cache_extent(n, ax) if ax in split else n
                          for n, ax in zip(*sa))
            return torch.zeros(shape, dtype=F32 if name == "state" else dtype,
                               device=device)

        return map_cache_spec(leaf, self.cache_specs(batch, cache_len))

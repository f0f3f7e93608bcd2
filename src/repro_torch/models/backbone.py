"""Backbone of the port: the ``dit``, ``dense``, ``moe``, ``ssm`` and
``hybrid`` branches of ``repro.models.backbone``.

The spec is the reference's whole tree (embedding, final norm, LM head and
the stacked blocks), so parameter trees cross between the packages key for
key.  ``forward_embeds`` runs the blocks as a Python loop over slices of
the stacked leaves where the reference scans; the slices are views, so
gradients reach the stacked leaves.  ``dit`` runs the bidirectional
adaLN-zero blocks, ``dense`` the pre-norm blocks ``[ln, attention, ln,
SwiGLU]`` with no modulation (the LM family, run causally by the flow
adapter), ``ssm`` the Mamba-2 blocks ``[ln, SSD]`` (causal by
construction).  ``hybrid`` (Zamba2) stacks the Mamba-2 blocks twice,
``(n_layers // attn_every, attn_every, ...)`` with the outer axis named
"groups", and after each group's SSM blocks applies the one *shared*
``[ln, attention, ln, SwiGLU]`` block (``shared_attn``, unstacked), so its
gradient is the sum over its ``n_layers // attn_every`` sites.  The shared
attention runs causally with the caller's ``window``: the flow adapter
passes 0, as the reference does, so the config's sliding window (8192 for
``zamba2-2.7b``) does not act on the velocity path.  ``moe`` (grok-1,
DeepSeek-V2) runs the dense family's blocks with the SwiGLU replaced by
the mixture of experts (``models/moe.py``), after ``first_k_dense`` plain
blocks stacked apart as ``dense_blocks``; with ``cfg.mla`` set the
attention is the latent attention of ``models/mla.py``.  The MoE blocks'
auxiliary losses are discarded, as the reference's flow adapter discards
them.  The frontend families (``vlm``, ``audio``) and the decode paths
are not ported yet.

On a mesh with a "model" axis each block first gathers its slice of the
sharded leaves (``repro_torch.sharding.constrain_params``, where the
reference constrains each scan slice to the gathered layout), so the
block's kernels see whole weights (each against its own unstacked spec:
dense or MoE); the hybrid's shared block is gathered at each of its
sites, as the reference's ``_gather`` does inside its scan.

``remat=True`` (``PerfConfig.remat="block"``) runs each block call (each
group of the hybrid: the reference's ``jax.checkpoint`` wraps its group
body) under ``torch.utils.checkpoint`` (non-reentrant) when grad is
enabled: the backward keeps each unit's inputs only and runs its forward
again, kernels included, as the reference's ``jax.checkpoint`` around its
scan body does, the gather included (a second all-gather).  The blocks
draw nothing, so the RNG state is not stashed.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shlib
from repro_torch.config import ArchConfig
from repro_torch.models import attention, layers, mla, moe, ssm
from repro_torch.models.params import P, stack

PORTED_FAMILIES = ("dit", "dense", "moe", "ssm", "hybrid")


def _not_ported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"backbone family {family!r} is not ported to repro_torch yet "
        "(ROADMAP.md Queue 1: 'Other families'); 'dit' (flux_dit), 'dense' "
        "(smollm-360m, yi-9b, yi-34b, qwen3-32b), 'moe' (grok-1-314b, "
        "deepseek-v2-236b), 'ssm' (mamba2-370m) and 'hybrid' (zamba2-2.7b), "
        "full-sequence forward, run")


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


class Backbone:
    def __init__(self, cfg: ArchConfig):
        if cfg.family not in PORTED_FAMILIES:
            raise _not_ported(cfg.family)
        self.cfg = cfg
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
        return s

    def _attn_block(self, p: Dict, x: torch.Tensor, *, causal: bool,
                    window: int, positions: torch.Tensor,
                    cond: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mod = torch.matmul(cond, p["ada"].to(cond.dtype)).to(x.dtype)
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mod, 6, dim=-1)
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        h = h * (1 + sc_a[:, None]) + sh_a[:, None]
        a_out = attention.apply_full(p["attn"], cfg, h, causal=causal,
                                     window=window, positions=positions)
        x = x + g_a[:, None] * a_out
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        h = h * (1 + sc_m[:, None]) + sh_m[:, None]
        return x + g_m[:, None] * layers.mlp(p["ffn"], h)

    def _dense_block(self, p: Dict, x: torch.Tensor, *, causal: bool,
                     window: int, positions: torch.Tensor,
                     ffn: str = "mlp") -> torch.Tensor:
        """[ln, attention, ln, FFN]: the dense family's block, the
        hybrid's shared block and the MoE family's (MLA attention with
        ``cfg.mla``; ``ffn="moe"``: the mixture of experts)."""
        cfg = self.cfg
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        attn_fn = mla.apply_full if cfg.mla else attention.apply_full
        x = x + attn_fn(p["attn"], cfg, h, causal=causal, window=window,
                        positions=positions)
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if ffn == "moe":
            return x + moe.apply(p["ffn"], cfg, h)[0]
        return x + layers.mlp(p["ffn"], h)

    def _ssm_block(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        h = layers.rmsnorm(p["ln"], x, self.cfg.norm_eps)
        out, _ = ssm.apply_full(p["ssm"], self.cfg, h)
        return x + out

    def forward_embeds(self, params: Dict, x: torch.Tensor, *,
                       causal: bool = True, window: int = 0,
                       cond: Optional[torch.Tensor] = None,
                       remat: bool = False) -> torch.Tensor:
        """Run all blocks over embedded inputs x: (B, S, d); returns the
        normed hidden states.  ``dit`` needs the adaLN conditioning vector
        ``cond`` (B, d); ``dense``, ``moe`` and ``hybrid`` take none; ``ssm`` is
        causal whatever ``causal`` says and takes no ``cond``.  ``remat``
        checkpoints each block, each group of the hybrid (module
        docstring)."""
        cfg = self.cfg
        if cfg.family == "dit" and cond is None:
            raise _not_ported("dit without adaLN conditioning")
        mesh = shlib.current_mesh()
        if cfg.family != "ssm":
            positions = torch.arange(x.shape[1], dtype=torch.int32,
                                     device=x.device)
            kw = dict(causal=causal, window=window, positions=positions)
        if cfg.family in ("ssm", "hybrid"):
            block = self._ssm_block
        elif cfg.family in ("dense", "moe"):
            block = functools.partial(self._dense_block, **kw)
            if cfg.family == "moe":
                dense_block, block = block, functools.partial(
                    self._dense_block, ffn="moe", **kw)
        else:
            block = functools.partial(self._attn_block, cond=cond, **kw)

        def run(p, x, spec=self._block_spec, block=block):
            return block(shlib.constrain_params(p, spec, mesh), x)

        if cfg.family == "hybrid":
            shared = functools.partial(self._dense_block, **kw)

            def run_group(ps, p_shared, x):
                for p in ps:
                    x = run(p, x)
                return shared(shlib.constrain_params(
                    p_shared, self._shared_spec, mesh), x)

            every = self._every
            slices = _unbind(params["blocks"], self._groups * every, axes=2)
            units = [(run_group, (slices[i:i + every], params["shared_attn"]))
                     for i in range(0, len(slices), every)]
        else:
            units = []
            if self._first_dense:
                run_dense = functools.partial(run, spec=self._dense_spec,
                                              block=dense_block)
                units = [(run_dense, (p,)) for p in _unbind(
                    params["dense_blocks"], self._first_dense)]
            units += [(run, (p,)) for p in _unbind(
                params["blocks"], cfg.n_layers - self._first_dense)]
        remat = remat and torch.is_grad_enabled()
        for fn, args in units:
            if remat:
                x = checkpoint(fn, *args, x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = fn(*args, x)
        return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)

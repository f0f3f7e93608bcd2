"""Backbone of the port: the ``dit`` branch of ``repro.models.backbone``.

The spec is the reference's whole tree (embedding, final norm, LM head and
``n_layers`` stacked blocks), so parameter trees cross between the packages
key for key.  ``forward_embeds`` runs the bidirectional adaLN-zero blocks as
a Python loop over slices of the stacked ``(n_layers, ...)`` leaves where
the reference scans; the slices are views, so gradients reach the stacked
leaves.  The other families are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.config import ArchConfig
from repro_torch.models import attention, layers
from repro_torch.models.params import P, stack

PORTED_FAMILIES = ("dit",)


def _not_ported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"backbone family {family!r} is not ported to repro_torch yet "
        "(ROADMAP.md Queue 1: 'Causal FlowAdapter path for the dense/LM "
        "family' and 'Other families'); only 'dit' runs")


def _attn_block_spec(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    return {
        "ln1": layers.rmsnorm_spec(d),
        "attn": attention.spec(cfg),
        "ln2": layers.rmsnorm_spec(d),
        "ffn": layers.mlp_spec(d, cfg.d_ff),
        # adaLN-zero: cond vector -> 6 modulation params per block
        "ada": P((d, 6 * d), ("embed", None), "zeros"),
    }


def _unbind(tree: Dict, n: int) -> List[Dict]:
    """The n per-layer slices of a stacked tree, as views.  Unbinding each
    leaf once (instead of indexing it once per layer) gives the backward
    one stack of the layers' gradients per leaf rather than a full-size
    zero-filled gradient for every layer."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


class Backbone:
    def __init__(self, cfg: ArchConfig):
        if cfg.family not in PORTED_FAMILIES:
            raise _not_ported(cfg.family)
        self.cfg = cfg

    def spec(self) -> Dict:
        cfg = self.cfg
        d = cfg.d_model
        s: Dict[str, Any] = {
            "embed": P((cfg.vocab_size, d), ("vocab", "embed"), "small"),
            "final_norm": layers.rmsnorm_spec(d),
            "blocks": stack(_attn_block_spec(cfg), cfg.n_layers),
        }
        if not cfg.tie_embeddings:
            s["lm_head"] = P((d, cfg.vocab_size), ("embed", "vocab"))
        return s

    def _attn_block(self, p: Dict, x: torch.Tensor, *, causal: bool,
                    window: int, positions: torch.Tensor,
                    cond: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mod = torch.matmul(cond, p["ada"]).to(x.dtype)
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = torch.chunk(mod, 6, dim=-1)
        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        h = h * (1 + sc_a[:, None]) + sh_a[:, None]
        a_out = attention.apply_full(p["attn"], cfg, h, causal=causal,
                                     window=window, positions=positions)
        x = x + g_a[:, None] * a_out
        h = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        h = h * (1 + sc_m[:, None]) + sh_m[:, None]
        return x + g_m[:, None] * layers.mlp(p["ffn"], h)

    def forward_embeds(self, params: Dict, x: torch.Tensor, *,
                       causal: bool = True, window: int = 0,
                       cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run all blocks over embedded inputs x: (B, S, d) with the
        adaLN conditioning vector ``cond`` (B, d); returns the normed
        hidden states."""
        if cond is None:
            raise _not_ported("dit without adaLN conditioning")
        cfg = self.cfg
        positions = torch.arange(x.shape[1], dtype=torch.int32,
                                 device=x.device)
        for p in _unbind(params["blocks"], cfg.n_layers):
            x = self._attn_block(p, x, causal=causal,
                                 window=window, positions=positions,
                                 cond=cond)
        return layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)

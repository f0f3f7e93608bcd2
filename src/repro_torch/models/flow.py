"""FlowAdapter — the paper's ``BaseAdapter`` model operation: a backbone as a
flow-matching velocity field ``v_θ(x_t, c, t)`` (``repro.models.flow``).

Latent tokens are projected into the backbone width, prefixed with projected
condition embeddings, run through the bidirectional adaLN-zero DiT with the
timestep embedding as the modulation vector, and projected back to latent
space.  The causal path of the LM families comes with those families.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import registry
from repro_torch.config import ArchConfig, FlowRLConfig
from repro_torch.models import layers
from repro_torch.models.backbone import Backbone
from repro_torch.models.params import P

F32 = torch.float32


@registry.register("adapter", "flow")
class FlowAdapter:
    """Velocity-field adapter over a Backbone."""

    def __init__(self, cfg: ArchConfig, flow_cfg: FlowRLConfig,
                 cond_dim: int = 512):
        self.cfg = cfg
        self.flow_cfg = flow_cfg
        self.cond_dim = cond_dim
        self.backbone = Backbone(cfg)

    def spec(self) -> Dict:
        d = self.cfg.d_model
        ld = self.flow_cfg.latent_dim
        return {
            "backbone": self.backbone.spec(),
            "latent_in": P((ld, d), ("latent", "embed")),
            "latent_out": P((d, ld), ("embed", "latent"), "small"),
            "time_w1": P((d, d), ("embed", "time")),
            "time_w2": P((d, d), ("time", "embed")),
            "cond_proj": P((self.cond_dim, d), ("cond", "embed")),
        }

    def velocity(self, params: Dict, x_t: torch.Tensor, t: torch.Tensor,
                 cond: torch.Tensor) -> torch.Tensor:
        """x_t: (B, Lt, latent_dim); t: (B,) in [0,1]; cond: (B, Lc,
        cond_dim).  Activations run in the parameter dtype; returns v:
        (B, Lt, latent_dim), always float32."""
        Lt = x_t.shape[1]
        dtype = params["latent_in"].dtype
        h_lat = torch.matmul(x_t.to(dtype), params["latent_in"]).to(dtype)
        h_cond = torch.matmul(cond.to(dtype), params["cond_proj"]).to(dtype)
        t_feat = layers.timestep_embedding(t, self.cfg.d_model).to(dtype)
        t_hid = torch.nn.functional.silu(
            torch.matmul(t_feat, params["time_w1"]).to(F32)).to(dtype)
        t_emb = torch.matmul(t_hid, params["time_w2"]).to(dtype)
        # bidirectional DiT: condition prefix + adaLN time modulation
        x = torch.cat([h_cond, h_lat], dim=1)
        hidden = self.backbone.forward_embeds(params["backbone"], x,
                                              causal=False, cond=t_emb)
        h_out = hidden[:, -Lt:]
        return torch.matmul(h_out.to(F32), params["latent_out"].to(F32))

    def init_latent(self, generator: torch.Generator, batch: int,
                    device=None) -> torch.Tensor:
        """(batch, Lt, ld) standard-normal prior drawn from ``generator``
        (on ``generator``'s device unless ``device`` is given)."""
        fc = self.flow_cfg
        return torch.randn((batch, fc.latent_tokens, fc.latent_dim),
                           generator=generator, dtype=F32,
                           device=device or generator.device)

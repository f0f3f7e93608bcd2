"""FlowAdapter — the paper's ``BaseAdapter`` model operation: a backbone as a
flow-matching velocity field ``v_θ(x_t, c, t)`` (``repro.models.flow``).

Latent tokens are projected into the backbone width, prefixed with projected
condition embeddings, run through the backbone, and projected back to latent
space.  The ``dit`` family runs bidirectionally with the timestep embedding
as the adaLN modulation vector (a FLUX-style DiT); the other families run
causally over ``[cond prefix; time token; latent tokens]`` (the ``ssm``
family and the SSM blocks of the hybrid causal by construction), with no
sliding window (``window=0``), as the reference runs them.  The frontend
families (``vlm``, ``audio``) run as the dense family: the velocity never
reads the frontend, so ``frontend_proj`` gets no gradient here.

On a mesh with a "model" axis the adapter's own sharded leaves (the
latent, time and condition projections) are gathered whole at the top of
``velocity`` and the backbone gathers each block's slice
(``repro_torch.sharding.constrain_params``).

``policy_dtype`` (``PerfConfig.policy_dtype``) sets the activation dtype;
None keeps the parameter dtype, the bitwise default.  ``velocity(...,
remat=True)`` checkpoints each backbone block (``PerfConfig.remat="block"``,
the loss side).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import registry
from repro_torch import sharding as shlib
from repro_torch.config import ArchConfig, FlowRLConfig
from repro_torch.models import layers
from repro_torch.models.backbone import Backbone
from repro_torch.models.params import P

F32 = torch.float32


@registry.register("adapter", "flow")
class FlowAdapter:
    """Velocity-field adapter over a Backbone."""

    # the adapter's own leaves, gathered whole on a "model" axis
    _OWN = ("latent_in", "latent_out", "time_w1", "time_w2", "cond_proj")

    def __init__(self, cfg: ArchConfig, flow_cfg: FlowRLConfig,
                 cond_dim: int = 512, policy_dtype=None):
        self.cfg = cfg
        self.flow_cfg = flow_cfg
        self.cond_dim = cond_dim
        self.backbone = Backbone(cfg)
        self.policy_dtype = policy_dtype
        self._spec = None

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
                 cond: torch.Tensor, *, remat: bool = False) -> torch.Tensor:
        """x_t: (B, Lt, latent_dim); t: (B,) in [0,1]; cond: (B, Lc,
        cond_dim).  Activations run in ``policy_dtype`` or else the
        parameter dtype; ``remat`` checkpoints each backbone block.
        Returns v: (B, Lt, latent_dim), always float32."""
        Lt = x_t.shape[1]
        if shlib.current_mesh() is not None:
            if self._spec is None:
                self._spec = self.spec()
            own = shlib.constrain_params(
                {k: params[k] for k in self._OWN},
                {k: self._spec[k] for k in self._OWN})
            params = dict(params, **own)
        dtype = self.policy_dtype or params["latent_in"].dtype
        h_lat = torch.matmul(x_t.to(dtype),
                             params["latent_in"].to(dtype)).to(dtype)
        h_cond = torch.matmul(cond.to(dtype),
                              params["cond_proj"].to(dtype)).to(dtype)
        t_feat = layers.timestep_embedding(t, self.cfg.d_model).to(dtype)
        t_hid = torch.nn.functional.silu(torch.matmul(
            t_feat, params["time_w1"].to(dtype)).to(F32)).to(dtype)
        t_emb = torch.matmul(t_hid, params["time_w2"].to(dtype)).to(dtype)
        if self.cfg.family == "dit":
            # bidirectional DiT: condition prefix + adaLN time modulation
            x = torch.cat([h_cond, h_lat], dim=1)
            hidden = self.backbone.forward_embeds(params["backbone"], x,
                                                  causal=False, cond=t_emb,
                                                  remat=remat)
        else:
            # causal DiT: [cond prefix; time token; latent tokens]
            x = torch.cat([h_cond, t_emb[:, None, :], h_lat], dim=1)
            hidden = self.backbone.forward_embeds(params["backbone"], x,
                                                  causal=True, remat=remat)
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

"""Serving side of the port's Experiment front door — ``FlowSampler``, a
thin client of :class:`repro_torch.serving.ServingEngine` (the port of
``repro.api.serving``).

It owns params + adapter + scheduler resolution and hands every batch to
the engine.  Without ``params`` it serves freshly initialised weights, drawn
on ``device`` from a generator seeded with ``seed``.  Request i of
``serve(cond, seed)`` runs under seed ``fold_seed(seed, i)``, so its latent
does not depend on ``max_batch`` or the bucket layout.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import schedulers
from repro_torch.device import resolve_device
from repro_torch.models import params as params_lib
from repro_torch.models.flow import FlowAdapter
from repro_torch.serving import ServingEngine

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class FlowSampler:
    """Batched sampling server over a FlowAdapter (engine-backed)."""

    def __init__(self, arch_cfg, flow_cfg, *, seed: int = 0, device=None,
                 param_dtype: str = "bfloat16", max_batch: int = 8,
                 cond_dim: int = 512, params=None,
                 buckets: Optional[Sequence[int]] = None,
                 step_tiers: Optional[Sequence[int]] = None,
                 deadline_s: float = 0.005, admission=None,
                 max_inflight: int = 4, dist=None, provider=None,
                 cond_len: int = 16):
        if param_dtype not in DTYPES:
            raise ValueError(f"param_dtype must be one of {sorted(DTYPES)}, "
                             f"got {param_dtype!r}")
        self.device = resolve_device(device)
        self.adapter = FlowAdapter(arch_cfg, flow_cfg, cond_dim)
        self.scheduler = schedulers.build(flow_cfg.sde_type, flow_cfg.eta)
        self.flow_cfg = flow_cfg
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = params_lib.init(self.adapter.spec(), gen,
                                     DTYPES[param_dtype], self.device)
        self.params = params
        self.max_batch = max_batch
        self.engine = ServingEngine(
            self.adapter, self.scheduler, self.params,
            num_steps=flow_cfg.num_steps, device=self.device,
            max_batch=max_batch, buckets=buckets, step_tiers=step_tiers,
            deadline_s=deadline_s, admission=admission,
            max_inflight=max_inflight, dist=dist, provider=provider,
            cond_len=cond_len)

    def warmup(self) -> dict:
        """Run the engine's bucket grid once; returns per-shape seconds."""
        return self.engine.warmup()

    def serve(self, cond, seed: int = 0) -> torch.Tensor:
        """cond: (N, Lc, D) -> latents (N, Lt, ld), bucket-batched through
        the engine."""
        return self.engine.serve(cond, seed)

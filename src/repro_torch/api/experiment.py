"""``Experiment`` — the config-first front door of the port, serve half
(the port of ``repro.api.experiment``).

One declarative :class:`RunConfig` resolves the arch (including ``reduced``
variants and ``arch_overrides``), the SDE scheduler and the live
``ConditionProvider`` by registry name, and builds the serving engine:

    exp = Experiment.from_cli(["--reduced", "--device", "cpu",
                               "--set", "flow.num_steps=4"])
    latents = exp.serve(["a fox in watercolor"])

Everything runs on ``device`` (default ``cuda``; without a CUDA device the
default raises).  ``train()`` and the training flags (``--trainer``,
``--steps``) come with the training slice.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

from repro_torch import registry
from repro_torch.api.overrides import apply_overrides, replace_fields
from repro_torch.api.serving import FlowSampler
from repro_torch.config import ArchConfig, FlowRLConfig, RunConfig, load_json
from repro_torch.core.preprocess import ConditionProvider
from repro_torch.device import resolve_device


def default_cli_config() -> RunConfig:
    """The reference CLI's defaults that serving reads: small latent
    geometry, 8 denoising steps."""
    return RunConfig(arch="flux_dit",
                     flow=FlowRLConfig(num_steps=8, latent_tokens=16,
                                       latent_dim=8))


class Experiment:
    """A fully-resolved run: config in, served latents out."""

    def __init__(self, cfg: RunConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._arch: Optional[ArchConfig] = None

    # ------------------------------------------------------------ construct
    @classmethod
    def from_config(cls, cfg: RunConfig, overrides: Sequence[str] = (),
                    device=None) -> "Experiment":
        if overrides:
            cfg = apply_overrides(cfg, overrides)
        return cls(cfg, device=device)

    @classmethod
    def from_file(cls, path: str, overrides: Sequence[str] = (),
                  device=None) -> "Experiment":
        return cls.from_config(load_json(RunConfig, path), overrides, device)

    @classmethod
    def cli_parser(cls, description: str = "Flow-Factory experiment"
                   ) -> argparse.ArgumentParser:
        """Shared parser: one config file + dotted overrides; convenience
        flag choices are derived from the registry."""
        ap = argparse.ArgumentParser(description=description)
        ap.add_argument("--config", default="",
                        help="RunConfig JSON (default: built-in profile)")
        ap.add_argument("--arch", default=None,
                        choices=registry.names("arch"))
        ap.add_argument("--reduced", action="store_true",
                        help="use the ≤2-layer reduced config")
        ap.add_argument("--sde", default=None,
                        choices=registry.names("scheduler"))
        ap.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; "
                             "'cpu' runs the kernels' plain versions)")
        ap.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="DOTTED.PATH=VALUE",
                        help="typed config override, e.g. --set "
                             "flow.eta=0.5")
        return ap

    @classmethod
    def from_args(cls, ns: argparse.Namespace,
                  base: Optional[RunConfig] = None) -> "Experiment":
        cfg = (load_json(RunConfig, ns.config) if ns.config
               else (base or default_cli_config()))
        pre: Dict[str, Any] = {}
        if ns.arch is not None:
            pre["arch"] = ns.arch
        if ns.reduced:
            pre["reduced"] = True
        if ns.sde is not None:
            pre["flow.sde_type"] = ns.sde
        cfg = apply_overrides(cfg, pre)
        return cls.from_config(cfg, ns.overrides, device=ns.device)

    @classmethod
    def from_cli(cls, argv: Optional[Sequence[str]] = None,
                 base: Optional[RunConfig] = None) -> "Experiment":
        return cls.from_args(cls.cli_parser().parse_args(argv), base)

    # -------------------------------------------------------------- resolve
    @property
    def arch(self) -> ArchConfig:
        if self._arch is None:
            arch = registry.build("arch", self.cfg.arch,
                                  reduced=self.cfg.reduced)
            self._arch = replace_fields(arch, self.cfg.arch_overrides)
        return self._arch

    @property
    def cond_dim(self) -> int:
        return int(self.cfg.data.encoder.get("cond_dim", 512))

    @property
    def cond_len(self) -> int:
        return int(self.cfg.data.encoder.get("cond_len", 16))

    @property
    def flow(self) -> FlowRLConfig:
        return self.cfg.flow

    def build_provider(self) -> ConditionProvider:
        """The live-encoding provider (serving encodes every new prompt;
        the engine's LRU cache skips repeats)."""
        return ConditionProvider(preprocessing=False,
                                 encoder_kw=dict(self.cfg.data.encoder),
                                 device=self.device)

    def build_sampler(self, max_batch: int = 8, params=None,
                      buckets: Optional[Sequence[int]] = None,
                      step_tiers: Optional[Sequence[int]] = None,
                      deadline_s: float = 0.005, admission=None,
                      max_inflight: int = 4, provider=None) -> FlowSampler:
        """A FlowSampler over ``params`` or, without them, over fresh
        weights in ``cfg.param_dtype`` drawn from ``cfg.seed``."""
        return FlowSampler(self.arch, self.flow, seed=self.cfg.seed,
                           device=self.device,
                           param_dtype=self.cfg.param_dtype,
                           max_batch=max_batch, cond_dim=self.cond_dim,
                           params=params, buckets=buckets,
                           step_tiers=step_tiers, deadline_s=deadline_s,
                           admission=admission, max_inflight=max_inflight,
                           dist=self.cfg.dist, provider=provider,
                           cond_len=self.cond_len)

    # ---------------------------------------------------------------- serve
    def build_engine(self, max_batch: int = 8, params=None,
                     buckets: Optional[Sequence[int]] = None,
                     step_tiers: Optional[Sequence[int]] = None,
                     deadline_s: float = 0.005, admission=None,
                     max_inflight: int = 4):
        """The serving engine directly (``repro_torch.serving
        .ServingEngine``), with a live ConditionProvider behind its LRU
        cond cache."""
        sampler = self.build_sampler(max_batch=max_batch, params=params,
                                     buckets=buckets, step_tiers=step_tiers,
                                     deadline_s=deadline_s,
                                     admission=admission,
                                     max_inflight=max_inflight,
                                     provider=self.build_provider())
        return sampler.engine

    def serve(self, prompts: Sequence[str], max_batch: int = 8,
              seed: Optional[int] = None, params=None,
              buckets: Optional[Sequence[int]] = None,
              deadline_s: float = 0.005):
        """Batched sampling for a list of prompt requests -> (N, Lt, ld)
        latents on the host."""
        seed = self.cfg.seed if seed is None else seed
        engine = self.build_engine(max_batch=max_batch, params=params,
                                   buckets=buckets, deadline_s=deadline_s)
        return engine.serve(list(prompts), seed)

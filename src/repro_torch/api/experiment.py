"""``Experiment`` — the config-first front door of the port (the port of
``repro.api.experiment``).

One declarative :class:`RunConfig` resolves the arch (including ``reduced``
variants and ``arch_overrides``), the trainer, SDE scheduler, rewards,
optimizer, dataset and the ``ConditionProvider`` by registry name:

    exp = Experiment.from_cli(["--reduced", "--device", "cpu",
                               "--steps", "2"])
    result = exp.train()                       # shared TrainLoop
    latents = exp.serve(["a fox in watercolor"])

Everything runs on ``device`` (default ``cuda``; without a CUDA device the
default raises).  ``cfg.dist`` lays the trainer and the serving engine out
on a (data, model) mesh over the process group the caller (``torchrun``
and the launch CLIs) initialised; ``describe()`` shows how it resolved.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import checkpoint, distributed, registry
from repro_torch.api import loop as loop_lib
from repro_torch.api.overrides import apply_overrides, replace_fields
from repro_torch.api.serving import DTYPES, FlowSampler
from repro_torch.config import (ArchConfig, ConfigError, FlowRLConfig,
                                LoopConfig, OptimConfig, RewardSpec,
                                RunConfig, load_json, to_dict)
from repro_torch.core.preprocess import (ConditionProvider, PreprocessCache,
                                         preprocess_dataset)
from repro_torch.device import resolve_device
from repro_torch.models import params as params_lib
from repro_torch.models.flow import FlowAdapter


def default_cli_config() -> RunConfig:
    """The reference CLI's defaults: small latent geometry, text_render
    reward, 100-step schedule."""
    return RunConfig(
        arch="flux_dit",
        flow=FlowRLConfig(
            num_steps=8, group_size=4, latent_tokens=16, latent_dim=8,
            rewards=(RewardSpec("text_render", 1.0),)),
        optim=OptimConfig(lr=3e-4, total_steps=100, warmup_steps=5),
        loop=LoopConfig(steps=100))


class Experiment:
    """A fully-resolved run: config in, trained state / served latents
    out."""

    def __init__(self, cfg: RunConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        # an injected mesh for the trainer and the engine in place of the
        # one cfg.dist resolves to (a one-rank group's (1, 1) included)
        self.mesh = None
        self._arch: Optional[ArchConfig] = None
        self._trainer = None
        self._dataset = None

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
        ap.add_argument("--trainer", default=None,
                        choices=registry.names("trainer"))
        ap.add_argument("--sde", default=None,
                        choices=registry.names("scheduler"))
        ap.add_argument("--steps", type=int, default=None)
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
        if ns.trainer is not None:
            pre["flow.trainer_type"] = ns.trainer
        if ns.sde is not None:
            pre["flow.sde_type"] = ns.sde
        if ns.steps is not None:
            pre["loop.steps"] = ns.steps
            pre["optim.total_steps"] = ns.steps
            pre["optim.warmup_steps"] = max(2, ns.steps // 20)
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
        """FlowRLConfig with reward args auto-completed: any reward
        parameter named latent_dim / latent_tokens / cond_dim that the spec
        leaves unset is filled from the run's latent/condition geometry."""
        f = self.cfg.flow
        auto = {"latent_dim": f.latent_dim, "latent_tokens": f.latent_tokens,
                "cond_dim": self.cond_dim}
        filled = []
        for spec in f.rewards:
            accepted = registry.describe("reward", spec.reward_type)["params"]
            args = dict(spec.args)
            args.update({k: v for k, v in auto.items()
                         if k in accepted and k not in args})
            filled.append(dataclasses.replace(spec, args=args))
        return dataclasses.replace(f, rewards=tuple(filled))

    @property
    def param_dtype(self) -> torch.dtype:
        if self.cfg.param_dtype not in DTYPES:
            raise ConfigError(f"param_dtype must be one of {sorted(DTYPES)}, "
                              f"got {self.cfg.param_dtype!r}")
        return DTYPES[self.cfg.param_dtype]

    def build_dataset(self):
        if self._dataset is None:
            d = self.cfg.data
            self._dataset = registry.build_from_config(
                "dataset",
                {"type": d.dataset,
                 "args": {"n_prompts": d.n_prompts,
                          "batch_prompts": d.batch_prompts,
                          "seed": self.cfg.seed, **d.args}})
        return self._dataset

    def build_provider(self, prompts: Optional[Sequence[str]] = None,
                       live: bool = False) -> ConditionProvider:
        """With preprocessing on (and not ``live``), encode and cache
        ``prompts`` once and return a cache-backed provider (the encoder is
        then dropped); otherwise a live-encoding provider (serving encodes
        every new prompt; the engine's LRU cache skips repeats)."""
        f, d = self.cfg.flow, self.cfg.data
        if live or not f.preprocessing:
            return ConditionProvider(preprocessing=False,
                                     encoder_kw=dict(d.encoder),
                                     device=self.device)
        # one sub-directory per encoder config, named as the reference names
        # it, so either package reads the other's cache
        enc_tag = hashlib.sha1(
            json.dumps(d.encoder, sort_keys=True).encode()).hexdigest()[:10]
        cache = PreprocessCache(os.path.join(f.cache_dir, f"enc_{enc_tag}"))
        if prompts:
            preprocess_dataset(prompts, cache, device=self.device,
                               **d.encoder)
        return ConditionProvider(preprocessing=True, cache=cache,
                                 device=self.device)

    def build_trainer(self):
        if self._trainer is None:
            self._trainer = registry.build_from_config(
                "trainer", self.cfg.flow.trainer_type,
                self.arch, self.flow, self.cfg.optim,
                seed=self.cfg.seed, cond_dim=self.cond_dim,
                dtype=self.param_dtype, device=self.device,
                dist=self.cfg.dist, perf=self.cfg.perf, mesh=self.mesh)
        return self._trainer

    def describe(self) -> Dict[str, Any]:
        """Resolved-component summary (``registry.describe``)."""
        f = self.cfg.flow
        arch = self.arch
        dp, mp = distributed.resolve_axes(self.cfg.dist)
        n = params_lib.n_params(FlowAdapter(arch, f, self.cond_dim).spec())
        return {
            "arch": {"name": arch.name, "family": arch.family,
                     "n_params": n},
            "trainer": registry.describe("trainer", f.trainer_type),
            "scheduler": registry.describe("scheduler", f.sde_type),
            "rewards": [s.reward_type for s in f.rewards],
            "optimizer": registry.describe("optimizer",
                                           self.cfg.optim.optimizer),
            "dataset": registry.describe("dataset", self.cfg.data.dataset),
            "device": str(self.device),
            "dist": {"devices": distributed.world_size(),
                     "data_parallel": dp, "model_parallel": mp,
                     "microbatch": self.cfg.dist.microbatch},
        }

    # ---------------------------------------------------------------- train
    def _ckpt_identity(self) -> Dict[str, Any]:
        """The config subset that must match for a checkpoint to resume:
        everything but the loop knobs, the schedule length, the device
        layout and the perf policy."""
        ident = to_dict(self.cfg)
        ident.pop("loop", None)
        ident.pop("dist", None)
        ident.pop("perf", None)
        for k in ("total_steps", "warmup_steps"):
            ident["optim"].pop(k, None)
        return json.loads(json.dumps(ident))

    def _identity_path(self, ckpt_dir: str) -> str:
        return os.path.join(ckpt_dir, "experiment.json")

    def _write_ckpt_identity(self, ckpt_dir: str) -> None:
        if not distributed.is_main_process():
            return
        os.makedirs(ckpt_dir, exist_ok=True)
        with open(self._identity_path(ckpt_dir), "w") as f:
            json.dump(self._ckpt_identity(), f, indent=1)

    def _check_ckpt_identity(self, ckpt_dir: str) -> None:
        path = self._identity_path(ckpt_dir)
        if not os.path.exists(path):
            return                       # no identity file: tolerate
        with open(path) as f:
            saved = json.load(f)
        saved.pop("dist", None)
        saved.pop("perf", None)
        for k in ("total_steps", "warmup_steps"):
            saved.get("optim", {}).pop(k, None)
        current = self._ckpt_identity()
        if saved != current:
            diff = sorted(k for k in set(saved) | set(current)
                          if saved.get(k) != current.get(k))
            raise ConfigError(
                f"checkpoint dir {ckpt_dir!r} was written by a different "
                f"experiment (mismatched: {diff}); refusing to resume — "
                "point loop.ckpt_dir elsewhere or set loop.resume=false")

    def default_callbacks(self) -> List[loop_lib.Callback]:
        lc = self.cfg.loop
        cbs: List[loop_lib.Callback] = []
        if lc.log_every:
            cbs.append(loop_lib.MetricLogger(lc.log_every))
        # log sink before checkpoint, as in the reference
        if lc.log_file:
            cbs.append(loop_lib.JSONLogSink(lc.log_file,
                                            lc.log_flush_every))
        if lc.save_every:
            cbs.append(loop_lib.PeriodicCheckpoint(lc.ckpt_dir,
                                                   lc.save_every))
        if lc.early_stop_patience:
            cbs.append(loop_lib.EarlyStop(lc.early_stop_metric,
                                          lc.early_stop_patience,
                                          lc.early_stop_min_delta))
        return cbs

    def train(self, callbacks: Sequence[loop_lib.Callback] = (),
              resume: Optional[bool] = None) -> Dict[str, Any]:
        """Run the shared TrainLoop end to end.

        Returns ``{"history", "state", "start_step", "final_step"}``.  With
        ``resume`` (default ``cfg.loop.resume``) the latest checkpoint in
        ``cfg.loop.ckpt_dir`` restores the full RLState first.
        ``callbacks`` extend the config-driven defaults."""
        lc = self.cfg.loop
        ds = self.build_dataset()
        provider = self.build_provider(ds.prompts)
        trainer = self.build_trainer()

        start_step = 0
        resume = lc.resume if resume is None else resume
        if resume and checkpoint.latest_step(lc.ckpt_dir) is not None:
            self._check_ckpt_identity(lc.ckpt_dir)
            try:
                # the canonical leaves on disk, cut to this rank's shards
                step, state = checkpoint.restore_latest(
                    lc.ckpt_dir, trainer.state, trainer.state_slicer())
            except ValueError as e:
                raise ConfigError(
                    f"cannot resume from {lc.ckpt_dir!r}: {e} — set "
                    "loop.resume=false or point loop.ckpt_dir elsewhere"
                ) from None
            trainer.state = state
            start_step = step
            if distributed.is_main_process():
                print(f"[resume] restored full RLState at step {step} "
                      f"from {lc.ckpt_dir}", flush=True)
        if lc.save_every:
            if not resume and checkpoint.latest_step(lc.ckpt_dir) is not None:
                raise ConfigError(
                    f"loop.ckpt_dir {lc.ckpt_dir!r} already contains "
                    "checkpoints; starting fresh (resume=false) would mix "
                    "runs — remove them or point loop.ckpt_dir elsewhere")
            self._write_ckpt_identity(lc.ckpt_dir)

        train_loop = loop_lib.TrainLoop(
            trainer, provider, ds, steps=lc.steps, seed=self.cfg.seed,
            start_step=start_step, pipeline=lc.pipeline,
            callbacks=self.default_callbacks() + list(callbacks))
        history = train_loop.run()
        final = history[-1]["step"] + 1 if history else start_step
        return {"history": history, "state": trainer.state,
                "start_step": start_step, "final_step": final}

    # ---------------------------------------------------------------- serve
    def build_sampler(self, max_batch: int = 8, params=None,
                      buckets: Optional[Sequence[int]] = None,
                      step_tiers: Optional[Sequence[int]] = None,
                      deadline_s: float = 0.005, admission=None,
                      max_inflight: int = 4, provider=None) -> FlowSampler:
        """A FlowSampler over ``params`` or, after ``train()``, over the
        trained state, or over fresh weights in ``cfg.param_dtype`` drawn
        from ``cfg.seed``."""
        if params is None and self._trainer is not None:
            params = self._trainer.state.params
        return FlowSampler(self.arch, self.flow, seed=self.cfg.seed,
                           device=self.device,
                           param_dtype=self.cfg.param_dtype,
                           max_batch=max_batch, cond_dim=self.cond_dim,
                           params=params, buckets=buckets,
                           step_tiers=step_tiers, deadline_s=deadline_s,
                           admission=admission, max_inflight=max_inflight,
                           dist=self.cfg.dist, provider=provider,
                           cond_len=self.cond_len, mesh=self.mesh)

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
                                     provider=self.build_provider(live=True))
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

"""Typed configuration of the port: the subset of ``repro.config`` that
serving and ``flow_grpo`` training read.

``ArchConfig`` (backbone geometry), ``FlowRLConfig`` (trainer, SDE dynamics,
rewards, preprocessing, latent geometry), ``OptimConfig``, ``DataConfig``
(prompt dataset and frozen encoder), ``DistConfig`` and ``PerfConfig``
(layouts and performance policies; only the defaults are ported),
``LoopConfig`` and ``RunConfig`` load from dicts/JSON through the same
strict typed :func:`from_dict` as the reference, with the reference's
defaults (``src/repro/config.py``).
"""
from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "dit")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    window: int = 0
    # citation of the source paper / model card for this config
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)


@dataclass(frozen=True)
class RewardSpec:
    """One entry of the multi-reward configuration (paper §2.3)."""
    reward_type: str                  # registry name
    weight: float = 1.0
    # identifies the underlying frozen model; entries sharing model_id are
    # deduplicated by MultiRewardLoader
    model_id: str = ""
    args: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class FlowRLConfig:
    """The paper's training configuration (the fields of the reference's
    ``FlowRLConfig`` that the ported trainer reads)."""
    trainer_type: str = "flow_grpo"      # only flow_grpo is ported
    sde_type: str = "flow_sde"           # flow_sde | dance_sde | cps | ode
    eta: float = 0.7                     # noise scale of the SDE dynamics
    num_steps: int = 10                  # denoising steps per trajectory
    group_size: int = 8                  # G samples per prompt (GRPO grouping)
    clip_range: float = 1e-4             # PPO clip range (Flow-GRPO)
    kl_coef: float = 0.0
    advantage_agg: str = "weighted_sum"  # weighted_sum | gdpo
    rewards: Tuple[RewardSpec, ...] = ()
    # preprocessing-based memory optimization (paper §2.2)
    preprocessing: bool = True
    cache_dir: str = "cache"
    latent_tokens: int = 64
    latent_dim: int = 16


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_steps: int = 10
    total_steps: int = 1000
    grad_clip: float = 1.0
    schedule: str = "warmup_cosine"      # warmup_cosine | constant
    optimizer: str = "adamw"             # registry name ("optimizer" kind)


@dataclass(frozen=True)
class DistConfig:
    """Device layout.  Only ``data_parallel = model_parallel = 1`` (one
    device) is ported; anything else raises ``NotImplementedError`` where an
    engine or a trainer is built (ROADMAP Queue 1 item 15)."""
    data_parallel: int = 1
    model_parallel: int = 1


@dataclass(frozen=True)
class PerfConfig:
    """Train-step performance policy (the reference's ``repro.perf``
    switches).  Only the defaults are ported: any other value raises
    ``NotImplementedError`` naming ROADMAP Queue 1 item 14."""
    remat: str = "none"            # none | scan | block
    fuse_step: bool = False
    policy_dtype: str = ""         # "" | "bfloat16" | "float32"
    log_memory: bool = False
    offload_rewards: bool = False
    remat_offload: bool = False


def check_ported_layout(dist: "DistConfig", perf: "PerfConfig") -> None:
    """Raise ``NotImplementedError`` for a layout or perf policy the port
    does not have yet."""
    if dist.data_parallel != 1 or dist.model_parallel != 1:
        raise NotImplementedError(
            f"dist={dist}: only the single-device layout is ported "
            "(ROADMAP.md Queue 1 item 15, distributed/)")
    if perf != PerfConfig():
        raise NotImplementedError(
            f"perf={perf}: only the default performance policy is ported "
            "(ROADMAP.md Queue 1 item 14, perf/)")


@dataclass(frozen=True)
class DataConfig:
    """Prompt-dataset + frozen-encoder selection for an Experiment."""
    dataset: str = "synthetic"           # registry name ("dataset" kind)
    n_prompts: int = 64
    batch_prompts: int = 4
    # extra kwargs forwarded to the registered dataset factory
    args: Dict[str, Any] = field(default_factory=dict)
    # kwargs of the frozen condition encoder (cond_dim/cond_len/vocab/...);
    # empty -> FrozenTextEncoder defaults (the paper-scale ~67M tower)
    encoder: Dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class LoopConfig:
    """TrainLoop behaviour: length, logging, checkpointing, early stop.
    ``pipeline`` must be 1 (the sequential loop); deeper pipelines are not
    ported (ROADMAP.md Queue 1 item 14)."""
    steps: int = 100
    pipeline: int = 1                    # max dispatched-not-drained steps
    log_every: int = 10                  # 0 -> silent
    save_every: int = 50                 # 0 -> no periodic checkpoints
    ckpt_dir: str = "checkpoints"
    log_file: str = ""                   # non-empty -> JSON metric sink
    log_flush_every: int = 1
    resume: bool = True                  # auto-resume from latest checkpoint
    early_stop_patience: int = 0         # 0 -> disabled
    early_stop_metric: str = "reward"    # any TrainLoop history-row key
    early_stop_min_delta: float = 0.0


@dataclass(frozen=True)
class RunConfig:
    arch: str = "flux_dit"
    # use the ≤2-layer reduced arch variant (CPU-runnable smoke scale)
    reduced: bool = False
    # declarative field overrides applied onto the resolved ArchConfig
    arch_overrides: Dict[str, Any] = field(default_factory=dict)
    optim: OptimConfig = field(default_factory=OptimConfig)
    flow: FlowRLConfig = field(default_factory=FlowRLConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    perf: PerfConfig = field(default_factory=PerfConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    param_dtype: str = "bfloat16"        # bfloat16 | float32
    seed: int = 0


# ---------------------------------------------------------------------------
# Loading — strict typed from_dict (nested dataclasses, tuples, Optional,
# Dict/List, unknown-key errors).
# ---------------------------------------------------------------------------


class ConfigError(TypeError):
    """Raised when a dict doesn't match the target dataclass schema."""


def _type_name(tp: Any) -> str:
    return getattr(tp, "__name__", None) or str(tp)


def coerce(value: Any, tp: Any, path: str = "<value>") -> Any:
    """Convert ``value`` to type ``tp`` (typing construct or dataclass),
    raising :class:`ConfigError` with the dotted ``path`` on mismatch."""
    if tp is Any or tp is dataclasses.MISSING:
        return value
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union:                      # Optional[T] / Union
        if value is None and type(None) in args:
            return None
        errors = []
        for cand in args:
            if cand is type(None):
                continue
            try:
                return coerce(value, cand, path)
            except ConfigError as e:
                errors.append(str(e))
        raise ConfigError(f"{path}: {value!r} matches no member of "
                          f"{_type_name(tp)} ({'; '.join(errors)})")
    if dataclasses.is_dataclass(tp) and isinstance(tp, type):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected a dict for "
                              f"{_type_name(tp)}, got {type(value).__name__}")
        return from_dict(tp, value, _path=path)
    if origin in (tuple,) or tp is tuple:
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected a sequence, got "
                              f"{type(value).__name__}")
        if not args:                                 # bare tuple
            return tuple(value)
        if len(args) == 2 and args[1] is Ellipsis:   # Tuple[T, ...]
            return tuple(coerce(v, args[0], f"{path}[{i}]")
                         for i, v in enumerate(value))
        if len(value) != len(args):                  # Tuple[T1, T2, ...]
            raise ConfigError(f"{path}: expected {len(args)} items, "
                              f"got {len(value)}")
        return tuple(coerce(v, a, f"{path}[{i}]")
                     for i, (v, a) in enumerate(zip(value, args)))
    if origin in (list,) or tp is list:
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected a list, got "
                              f"{type(value).__name__}")
        elem = args[0] if args else Any
        return [coerce(v, elem, f"{path}[{i}]") for i, v in enumerate(value)]
    if origin in (dict,) or tp is dict:
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected a dict, got "
                              f"{type(value).__name__}")
        kt, vt = args if args else (Any, Any)
        return {coerce(k, kt, f"{path}<key>"): coerce(v, vt, f"{path}[{k}]")
                for k, v in value.items()}
    if tp is bool:
        if isinstance(value, bool):
            return value
        raise ConfigError(f"{path}: expected bool, got {value!r}")
    if tp is int:
        if isinstance(value, int) and not isinstance(value, bool):
            return value
        raise ConfigError(f"{path}: expected int, got {value!r}")
    if tp is float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return float(value)
        raise ConfigError(f"{path}: expected float, got {value!r}")
    if tp is str:
        if isinstance(value, str):
            return value
        raise ConfigError(f"{path}: expected str, got {value!r}")
    if isinstance(tp, type):
        if isinstance(value, tp):
            return value
        raise ConfigError(f"{path}: expected {_type_name(tp)}, got "
                          f"{type(value).__name__}")
    return value


def field_types(cls: type) -> Dict[str, Any]:
    """Resolved {field name: type} for a dataclass (PEP 563 safe)."""
    return typing.get_type_hints(cls)


def from_dict(cls: type, d: Dict[str, Any], *, _path: str = "") -> Any:
    """Strict typed construction of dataclass ``cls`` from a plain dict,
    raising :class:`ConfigError` on unknown keys or type mismatches (with
    the dotted field path)."""
    if not dataclasses.is_dataclass(cls):
        raise ConfigError(f"{cls!r} is not a dataclass")
    if not isinstance(d, dict):
        raise ConfigError(f"{_path or _type_name(cls)}: expected a dict, "
                          f"got {type(d).__name__}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ConfigError(
            f"{_path or _type_name(cls)}: unknown key(s) {unknown} for "
            f"{_type_name(cls)}; valid keys: {sorted(names)}")
    hints = field_types(cls)
    kwargs = {k: coerce(v, hints[k], f"{_path}.{k}" if _path else k)
              for k, v in d.items()}
    try:
        return cls(**kwargs)
    except TypeError as e:                # e.g. missing required field
        raise ConfigError(f"{_path or _type_name(cls)}: {e}") from None


def load_json(cls: type, path: str) -> Any:
    with open(path) as f:
        return from_dict(cls, json.load(f))


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def replace(cfg: Any, **kw: Any) -> Any:
    return dataclasses.replace(cfg, **kw)

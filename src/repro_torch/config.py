"""Typed configuration of the port: the subset of ``repro.config`` that
serving, the five trainers and the LM task path read.

``ArchConfig`` (backbone geometry, with ``MoEConfig`` for the
mixture-of-experts FFN, ``MLAConfig`` for DeepSeek-V2's latent attention,
``SSMConfig`` for the Mamba-2 block, ``HybridConfig`` for the Zamba2
schedule and ``FrontendConfig`` for the stub modality frontends),
``InputShape`` with the LM task path's ``INPUT_SHAPES``, ``FlowRLConfig``
(trainer, SDE dynamics, rewards, preprocessing, latent geometry),
``OptimConfig``, ``DataConfig`` (prompt dataset and frozen encoder),
``DistConfig`` and ``PerfConfig`` (the (data, model) device layout and the
performance policies), ``LoopConfig`` and ``RunConfig`` load from
dicts/JSON through the same strict typed :func:`from_dict` as the
reference, with the reference's defaults (``src/repro/config.py``).
"""
from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio", "dit")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    # d_ff of each routed expert (dense d_ff field is used for dense layers)
    expert_d_ff: int = 0
    # first k layers stay dense (deepseek-v2 style)
    first_k_dense: int = 0
    # load-balance auxiliary loss coefficient
    aux_loss_coef: float = 0.01
    # router jitter / z-loss
    router_z_coef: float = 1e-3
    # sharding strategy: "tensor" (shard expert d_ff) | "expert" (all-to-all)
    sharding: str = "tensor"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD block."""
    d_state: int = 64
    expand: int = 2            # d_inner = expand * d_model
    head_dim: int = 64         # SSD head dim (n_heads = d_inner // head_dim)
    chunk: int = 128           # chunked-scan block length
    d_conv: int = 4            # depthwise conv width


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid schedule: runs of SSM blocks with a periodically
    applied *shared* attention block (single parameter set reused)."""
    attn_every: int = 6        # one attn application per `attn_every` layers
    shared_attn: bool = True   # reuse one attention block's params


@dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: precomputed patch/frame embeddings of the
    right shape stand in for the encoder; the decoder consumes them."""
    kind: str = "none"         # none | vision | audio
    n_tokens: int = 0          # prefix length contributed by the frontend
    embed_dim: int = 0         # embedding dim delivered (projected to d_model)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int                      # 0 for attn-free (ssm)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    window: int = 0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    # citation of the source paper / model card for this config
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def n_params(self) -> int:
        """Total backbone parameter count, the reference's analytic one
        (embeddings, layers and final norm; a frontend's projection is not
        counted)."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "hybrid":
            hy = self.hybrid or HybridConfig()
            copies = 1 if hy.shared_attn else self.n_layers // hy.attn_every
            attn = (_attn_params(self, self.resolved_head_dim)
                    + 3 * d * self.d_ff)
            return (emb + self.n_layers * _ssm_layer_params(self)
                    + copies * attn + d)
        if self.family == "ssm":
            per_layer = _ssm_layer_params(self)
        else:
            attn = (_mla_params(self) if self.mla
                    else _attn_params(self, self.resolved_head_dim))
            if self.moe and self.moe.n_experts:
                m = self.moe
                moe_layers = self.n_layers - m.first_k_dense
                ffn_moe = d * m.n_experts + (
                    (m.n_experts + m.n_shared_experts) * 3 * d
                    * m.expert_d_ff)
                return (emb + self.n_layers * (attn + 2 * d)
                        + moe_layers * ffn_moe
                        + m.first_k_dense * 3 * d * self.d_ff + d)
            per_layer = attn + 3 * d * self.d_ff + 2 * d
        return emb + self.n_layers * per_layer + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if not (self.moe and self.moe.n_experts):
            return self.n_params()
        d, m = self.d_model, self.moe
        attn = (_mla_params(self) if self.mla
                else _attn_params(self, self.resolved_head_dim))
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        moe_layers = self.n_layers - m.first_k_dense
        active_ffn = ((m.top_k + m.n_shared_experts) * 3 * d * m.expert_d_ff
                      + d * m.n_experts)
        return (emb + self.n_layers * (attn + 2 * d)
                + moe_layers * active_ffn
                + m.first_k_dense * 3 * d * self.d_ff + d)


def _attn_params(cfg: ArchConfig, hd: int) -> int:
    d = cfg.d_model
    return (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * d)


def _mla_params(cfg: ArchConfig) -> int:
    m = cfg.mla
    d = cfg.d_model
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * qk
            + d * (m.kv_lora_rank + m.qk_rope_head_dim)
            + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_head_dim
                                              + m.v_head_dim)
            + cfg.n_heads * m.v_head_dim * d)


def _ssm_layer_params(cfg: ArchConfig) -> int:
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    d_in = s.expand * d
    n_heads = d_in // s.head_dim
    # in_proj produces [z, x, B, C, dt]
    in_proj = d * (2 * d_in + 2 * s.d_state + n_heads)
    return (in_proj + d_in * d + s.d_conv * (d_in + 2 * s.d_state)
            + 2 * n_heads + d)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


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
    """The paper's training configuration (the reference's
    ``FlowRLConfig``, field for field)."""
    trainer_type: str = "flow_grpo"      # flow_grpo | mix_grpo | grpo_guard | nft | awm
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
    # timestep sampling for NFT/AWM (solver-agnostic algorithms, paper §3.2)
    timestep_sampling: str = "uniform"   # uniform | logit_normal | discrete
    # MixGRPO: how many leading timesteps get SDE treatment
    sde_window: int = 2
    sde_window_shift_every: int = 0      # >0: slide the window during training
    # latent geometry of the flow policy
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
class MeshConfig:
    """The reference's production-mesh description (``launch.mesh``),
    field for field; the port's running layout is ``DistConfig``."""
    data: int = 1
    model: int = 1
    pods: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pods


@dataclass(frozen=True)
class ShardingConfig:
    """The reference's sharding switches, field for field, accepted so
    its run files load; the port's layout is fixed by its
    ``PartitionPlan`` (ZeRO-3 over "model") and ``PerfConfig.remat``."""
    # fsdp: additionally shard params over the data axis (zero-3)
    fsdp: bool = True
    # shard long decode KV caches over the data axis (distributed flash-decode)
    seq_shard_decode: bool = True
    # remat policy for train: "none" | "block" (checkpoint each layer block)
    remat: str = "block"


@dataclass(frozen=True)
class DistConfig:
    """Distributed layout (``repro_torch.distributed``): a 2-D
    ``("data", "model")`` mesh over the ranks of the process group.

    ``data_parallel``: ranks on the "data" axis, over which the prompts x
    groups batch is split; 1 (default) with ``model_parallel`` 1 is the
    single-device path (no mesh, no collective); 0 means "every rank not
    claimed by model_parallel".  ``model_parallel``: ranks on the "model"
    axis, over which params and AdamW moments are sharded per the
    ``PartitionPlan`` and gathered one layer at a time before use; 0 means
    "every rank not claimed by data_parallel".  ``dp x mp`` is resolved
    against the process group's world size (1 without a group).
    ``microbatch``: split each batch into this many sequential
    gradient-accumulation chunks (0/1 = one full-batch pass).
    ``donate_state``: the reference donates the state to its jitted
    update; the port's update is in place either way, so the field is
    accepted, validated and changes nothing.  All four are runtime
    choices, not experiment identity: a checkpoint written at one layout
    resumes at any other."""
    data_parallel: int = 1
    model_parallel: int = 1
    microbatch: int = 0
    donate_state: bool = True


@dataclass(frozen=True)
class PerfConfig:
    """Train-step performance policy (``repro_torch.perf``), the
    reference's switches with its defaults and validation.

    A *runtime* choice, not experiment identity: checkpoints written under
    one policy resume under any other.  ``remat``: ``"none"``; ``"scan"``,
    which in the port is the program of ``"none"`` (its losses already
    back-propagate one timestep at a time); ``"block"`` checkpoints each
    backbone layer of the loss's velocity forward and recomputes it in the
    backward (f32-rounding-equal).  ``fuse_step``: sample, rewards,
    advantages and update as one function, captured once per SDE-mask
    pattern into a CUDA graph and replayed (eager on the CPU).
    ``policy_dtype``: the activation dtype of the velocity field ("" = the
    parameter dtype; log-probabilities and the optimizer stay f32).
    ``log_memory``: report ``memory_stats`` at train start.
    ``offload_rewards``: keep the frozen reward towers in pinned host
    memory and copy them to the device for each step's reward phase.
    ``remat_offload`` (needs ``remat="scan"``): saved copies of the named
    velocity residual go to pinned host memory until the backward."""
    remat: str = "none"            # none | scan | block
    fuse_step: bool = False
    policy_dtype: str = ""         # "" | "bfloat16" | "float32"
    log_memory: bool = False
    offload_rewards: bool = False
    remat_offload: bool = False    # requires remat="scan"


def check_ported_layout(dist: "DistConfig", perf: "PerfConfig") -> None:
    """Raise ``ValueError`` for a perf policy the reference's ``validate``
    refuses, or a negative microbatch count (the layout's axes are
    resolved against the process group by ``distributed.resolve_axes``)."""
    from repro_torch.perf.policy import validate
    validate(perf)
    if dist.microbatch < 0:
        raise ValueError(
            f"dist.microbatch must be >= 0, got {dist.microbatch}")


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
    ``pipeline``: the most dispatched-not-yet-drained steps (1 = the
    sequential loop)."""
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
    arch: str = "smollm-360m"
    # use the ≤2-layer reduced arch variant (CPU-runnable smoke scale)
    reduced: bool = False
    # declarative field overrides applied onto the resolved ArchConfig
    arch_overrides: Dict[str, Any] = field(default_factory=dict)
    shape: str = "train_4k"
    mesh: MeshConfig = field(default_factory=MeshConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    flow: FlowRLConfig = field(default_factory=FlowRLConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    perf: PerfConfig = field(default_factory=PerfConfig)
    data: DataConfig = field(default_factory=DataConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    param_dtype: str = "bfloat16"        # bfloat16 | float32
    activ_dtype: str = "bfloat16"
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

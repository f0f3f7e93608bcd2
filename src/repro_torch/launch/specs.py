"""Meta-tensor stand-ins for every (arch × shape × mesh) dry-run
combination, and the steps that run on them — the port of
``repro.launch.specs``.  Nothing here allocates device memory: every
tensor of a step's state and inputs lies on ``device="meta"`` (shapes and
dtypes, no storage), apart from the few host values the port keeps on the
host (the AdamW step counter, a trajectory's time grid and SDE mask).

**The layout is the port's own.**  The reference returns
``NamedSharding`` trees for XLA's SPMD partitioner (FSDP over "data" as
well, tensor-parallel heads; ``repro.sharding``'s rule tables).  The port
has no partitioner and runs one layout: params and AdamW moments sharded
over "model" by the ``PartitionPlan`` (``model_shard_dim``), each layer's
slice gathered whole before use (ZeRO-3, ``sharding.constrain_params``),
the batch split over "data".  So each spec here is this rank's shard
(``PartitionPlan._local_shape``), and the second value of each pair is the
plan's tree of sharded dims (None where a leaf is whole).  A batch that
the data axis does not divide (``long_500k``'s one sequence) is run whole
by every data rank.  With ``mesh=None`` everything is the exact
single-device path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch import sharding as shlib
from repro_torch.config import (ArchConfig, DistConfig, FlowRLConfig,
                                InputShape, OptimConfig, PerfConfig)
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.distributed.sharding import partition_plan
from repro_torch.models import params as params_lib
from repro_torch.models import tasks
from repro_torch.models.backbone import Backbone

BF16 = torch.bfloat16
F32 = torch.float32
I32 = torch.int32
META = torch.device("meta")
# the flow update's batch: prompts x group (the reference's defaults)
FLOW_PROMPTS, FLOW_GROUP = 32, 8


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def local_batch(batch: int, mesh) -> int:
    """This rank's rows of a global batch: 1/dp of it, or all of it when
    the data axis does not divide it."""
    dp = mesh_lib.mesh_dp(mesh)
    return batch // dp if batch % dp == 0 else batch


def layout(mesh, batch: int) -> str:
    """The record's description of the layout a step runs under."""
    dp, mp = mesh_lib.mesh_dp(mesh), mesh_lib.mesh_mp(mesh)
    if mesh is None:
        return "single device: no mesh, no collective"
    split = (f"batch {batch} split over data ({dp})" if batch % dp == 0
             else f"batch {batch} whole on every data rank ({dp} does not "
                  "divide it)")
    return (f"port: params and AdamW moments sharded over model ({mp}) by "
            f"the PartitionPlan, each layer gathered whole before use "
            f"(ZeRO-3); {split}")


# ---------------------------------------------------------------------------
# Parameter / optimizer / cache specs
# ---------------------------------------------------------------------------

def _spec_shards(spec, mesh, dtype) -> Tuple[Any, Any]:
    """(this rank's meta shards, sharded-dim tree) of a param spec tree."""
    plan = partition_plan(mesh, spec)
    shapes: Dict = {}
    dims: Dict = {}
    for path, p in params_lib.leaves(spec):
        dim = (None if plan is None else
               params_lib.model_shard_dim(p.shape, p.axes,
                                          plan.model_parallel))
        local = p.shape if plan is None else plan._local_shape(p.shape, dim)
        params_lib._set(shapes, path, _meta(local, dtype))
        params_lib._set(dims, path, dim)
    return shapes, dims


def param_specs(cfg: ArchConfig, mesh) -> Tuple[Any, Any]:
    """(meta params tree of this rank's shards, sharded-dim tree) for the
    backbone in bf16: one layout for serving and training, where the
    reference's ``train`` switch picks between two."""
    return _spec_shards(Backbone(cfg).spec(), mesh, BF16)


def _state(p_shapes) -> optim.AdamWState:
    f32 = lambda t: _meta(t.shape, F32)
    return optim.AdamWState(
        step=torch.zeros((), dtype=I32),        # the host step counter
        mu=_map(p_shapes, f32), nu=_map(p_shapes, f32))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def train_state_specs(cfg: ArchConfig, mesh):
    """(meta ``TrainState``, sharded-dim tree of its params): bf16 params,
    f32 moments mirroring them, the step counter on the host."""
    p_shapes, p_dims = param_specs(cfg, mesh)
    return tasks.TrainState(params=p_shapes, opt=_state(p_shapes)), p_dims


def cache_specs(cfg: ArchConfig, shape: InputShape, mesh):
    """The caches ``tasks.init_caches`` preallocates for this rank's rows of
    a decode shape (bf16, the SSM state f32), on meta."""
    return tasks.init_caches(cfg, local_batch(shape.global_batch, mesh),
                             tasks.effective_cache_len(cfg, shape), BF16,
                             META)


# ---------------------------------------------------------------------------
# input_specs — every model input as a meta tensor (the dry-run contract)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape: InputShape, mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's batch inputs for the step kind of ``shape``: tokens and
    labels (train), tokens (prefill) or the one new token (decode), int32;
    a frontend arch's stub prefix embeddings (bf16) except at decode."""
    B, S = local_batch(shape.global_batch, mesh), shape.seq_len
    if shape.kind == "train":
        out = {"tokens": _meta((B, S), I32), "labels": _meta((B, S), I32)}
    elif shape.kind == "prefill":
        out = {"tokens": _meta((B, S), I32)}
    else:
        out = {"token": _meta((B, 1), I32)}
    if cfg.frontend.kind != "none" and shape.kind != "decode":
        fe = cfg.frontend
        out["prefix_embed"] = _meta((B, fe.n_tokens, fe.embed_dim), BF16)
    return out


# ---------------------------------------------------------------------------
# Step builders for the dry run
# ---------------------------------------------------------------------------

def _on_mesh(fn, mesh):
    """``fn`` run under the mesh's gather context (``fn`` itself without a
    mesh: the single-device path)."""
    if mesh is None:
        return fn

    def run(*args):
        with shlib.param_gather(mesh):
            return fn(*args)
    return run


def build_step(cfg: ArchConfig, shape: InputShape, mesh,
               opt_cfg: Optional[OptimConfig] = None):
    """Returns ``(fn, args)``: the port's own step for ``shape.kind``
    (``tasks.make_train_step`` with per-block remat, ``make_prefill_step``
    or ``make_decode_step``) and this rank's meta arguments; ``fn(*args)``
    runs it."""
    opt_cfg = opt_cfg or OptimConfig()
    window = tasks.effective_window(cfg, shape)
    batch = input_specs(cfg, shape, mesh)
    if shape.kind == "train":
        step = tasks.make_train_step(cfg, opt_cfg, window=window, remat=True)
        state, _ = train_state_specs(cfg, mesh)
        return _on_mesh(step, mesh), (state, batch)
    params, _ = param_specs(cfg, mesh)
    if shape.kind == "prefill":
        step = tasks.make_prefill_step(cfg, window=window)
        return _on_mesh(step, mesh), (params, batch)
    step = tasks.make_decode_step(cfg, window=window)
    caches = cache_specs(cfg, shape, mesh)
    # the token after a full cache: the ring's last slot at a window
    pos = tasks.effective_cache_len(cfg, shape) - 1
    return _on_mesh(step, mesh), (params, caches, batch["token"], pos)


# ---------------------------------------------------------------------------
# Flow-RL (paper pipeline) dry-run step: one GRPO update on trajectories
# ---------------------------------------------------------------------------

def build_flow_step(cfg: ArchConfig, mesh, *,
                    num_steps: int = 10, latent_tokens: int = 1024,
                    latent_dim: int = 16, cond_len: int = 16,
                    cond_dim: int = 512, group_size: int = FLOW_GROUP,
                    prompts: int = FLOW_PROMPTS):
    """The paper's own training step (the ``FlowGRPOTrainer`` update: the
    GRPO loss over every SDE step, its backward, the gradients' mesh
    averages, clip and AdamW) at production scale.  Returns ``(fn, (state,
    traj, adv))``; the trainer is built without params or reward towers
    (``__new__``, as the reference does), its state being the meta
    argument."""
    from repro_torch import registry
    from repro_torch.core import schedulers
    from repro_torch.core.rollout import Trajectory
    from repro_torch.core.trainers.base import RLState
    from repro_torch.core.trainers.grpo import FlowGRPOTrainer
    from repro_torch.models.flow import FlowAdapter

    flow_cfg = FlowRLConfig(num_steps=num_steps, group_size=group_size,
                            latent_tokens=latent_tokens, latent_dim=latent_dim)
    opt_cfg = OptimConfig()
    dp, mp = mesh_lib.mesh_dp(mesh), mesh_lib.mesh_mp(mesh)
    tr = FlowGRPOTrainer.__new__(FlowGRPOTrainer)
    tr.perf, tr.dist = PerfConfig(), DistConfig(data_parallel=dp,
                                                model_parallel=mp)
    tr.device, tr.mesh = META, mesh
    tr.cfg, tr.flow, tr.opt_cfg = cfg, flow_cfg, opt_cfg
    tr.adapter = FlowAdapter(cfg, flow_cfg, cond_dim)
    tr.sde_mode = "all_sde"
    tr.scheduler = schedulers.build(flow_cfg.sde_type, flow_cfg.eta)
    spec = tr.adapter.spec()
    tr.plan = partition_plan(mesh, spec)
    tr._dp, tr._mp = dp, mp
    p_shapes, p_dims = _spec_shards(spec, mesh, BF16)
    tr._sharded = frozenset(path for path, d in params_lib.leaves(p_dims)
                            if d is not None)
    if mesh is not None:
        tr._dgroup = mesh_lib.data_group(mesh)
        tr._mgroup = mesh_lib.model_group(mesh)
    tr._row_cache, tr._draw_rows = {}, None
    tr._engine, tr._fused = None, None
    tr.optimizer = registry.build("optimizer", opt_cfg.optimizer)
    tr._lr = optim.make_schedule(opt_cfg)
    tr._scalars = optim.step_scalars(META)
    state = RLState(params=p_shapes, opt=_state(p_shapes))

    B = local_batch(prompts * group_size, mesh)
    T = num_steps
    traj = Trajectory(
        xs=_meta((T + 1, B, latent_tokens, latent_dim), F32),
        logps=_meta((T, B), F32),
        # the host values the loss reads: the time grid and the SDE mask
        ts=torch.from_numpy(tr.scheduler.timesteps(T)).to(F32),
        sde_mask=torch.ones((T,), dtype=torch.bool),
        cond=_meta((B, cond_len, cond_dim), F32))
    adv = _meta((B,), F32)

    def fn(state, traj, adv):
        tr.state = state
        tr._begin_update()
        metrics = tr._update(traj, adv)
        tr._end_update()
        return metrics

    return fn, (state, traj, adv)

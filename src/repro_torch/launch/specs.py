"""Meta-tensor stand-ins for every (arch × shape × mesh) dry-run
combination, and the steps that run on them — the port of
``repro.launch.specs``.  Nothing here allocates device memory: every
tensor of a step's state and inputs lies on ``device="meta"`` (shapes and
dtypes, no storage), apart from the few host values the port keeps on the
host (the AdamW step counter, a trajectory's time grid and SDE mask).

**The layout is the reference's production layout** (``repro.sharding``'s
rule tables, ``repro_torch.sharding``): params and AdamW moments sharded
over "model" on ``heads``, ``kv_heads``, ``mlp``, ``vocab``, ``inner`` and
``experts_mdl``, and over "data" on ``embed``, ``embed_r``, ``moe_in`` and
``moe_out`` (``param_rules``, ``fsdp``), a sharding dropped where the
axis does not divide the dim; a leaf left whole on every rank that way
is stored over "model" as the trainers' ``PartitionPlan`` stores it and
gathered whole at use (``sharding.stored_layout``).  Inference weights
shard over "data" only when ``2 · n_params / mp`` exceeds
``INFERENCE_FSDP_THRESHOLD``.  At use each block gathers its "data"
shard (ZeRO-3 over "data", the expert tables' ``moe_in`` / ``moe_out``
too, ``sharding.DATA_GATHERED_AXES``) and keeps its "model" shard:
attention, MLA, the SwiGLU MLP, the routed experts' hidden dim, the
Mamba-2 blocks' SSD heads and the vocabulary run tensor-parallel; under
``ep_model`` each rank runs its E / mp routed experts at the whole hidden
dim (expert parallel), or, where the axis does not divide E, every
expert gathered whole (``sharding.GATHERED_WHOLE``).  Under
``REPRO_BF16_REDUCE`` the row-parallel partials are summed in bf16.  The batch splits over "data" and the
decode caches hold this rank's rows, kv heads, SSD heads and conv
channels (MLA's latent cache has no heads axis and stays whole over
"model"), and their sequence follows the reference's ``cache_seq`` rule
(:func:`cache_rules`): over "data" when the data axis does not divide
the batch, over the axis ``REPRO_CACHE_SEQ_SHARD`` names when that is
set, dropped where the axis does not divide the cache length, and a
layout with one mesh axis on two dims of a cache leaf refused
(``sharding.CacheLayoutError``, the reference's ``DuplicateSpecError``).
Where
the reference leaves a step's weights to XLA (``set_param_gather(None)``:
at decode always, at prefill and in training under
``REPRO_NO_WEIGHT_GATHER``, read with the reference's truthiness, "0"
too) the port takes the activation-gathered route
(``sharding.production_rules(activations=True)``): each matrix keeps its
"data" shard at use, each product gathers its rows over "data", sums its
d-partials back onto the rank's rows (the input side) or sends each row's
columns home by one all-to-all (the output side).  Prefill without the
switch gathers the "data" shard at use, as training does (a difference by
construction: the reference leaves prefill to XLA whatever the switch).
So each spec here is this rank's shard, and the second
value of each pair is the tree of each leaf's (data dim, model dim).  A
batch that the data axis does not divide (``long_500k``'s one sequence)
is run whole by every data rank (on the route its d-partials are then
all-reduced over "data").  ``build_flow_step(fsdp=False)`` keeps
the trainers' own layout (the ``PartitionPlan``: ZeRO-3 over "model").
With ``mesh=None`` everything is the exact single-device path.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import optim
from repro_torch import sharding as shlib
from repro_torch.config import (ArchConfig, DistConfig, FlowRLConfig,
                                InputShape, OptimConfig, PerfConfig)
from repro_torch.core.trainers.base import RLState
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.models import params as params_lib
from repro_torch.models import tasks
from repro_torch.models.backbone import Backbone, map_cache_spec

BF16 = torch.bfloat16
F32 = torch.float32
I32 = torch.int32
META = torch.device("meta")
# the flow update's batch: prompts x group (the reference's defaults)
FLOW_PROMPTS, FLOW_GROUP = 32, 8
# bytes a rank above which inference weights also shard over "data"
# (the reference's weight-gathered serving mode for 100B+ models)
INFERENCE_FSDP_THRESHOLD = 10e9


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def local_batch(batch: int, mesh) -> int:
    """This rank's rows of a global batch: 1/dp of it, or all of it when
    the data axis does not divide it."""
    dp = mesh_lib.mesh_dp(mesh)
    return batch // dp if batch % dp == 0 else batch


def layout(mesh, batch: int, *, fsdp: bool = True,
           cache_seq: Optional[str] = None, route: str = "weights") -> str:
    """The record's description of the layout a step runs under
    (``cache_seq``: the mesh axis a decode cache's sequence is split
    over; ``route``: ``Rules.route``)."""
    dp, mp = mesh_lib.mesh_dp(mesh), mesh_lib.mesh_mp(mesh)
    if mesh is None:
        return "single device: no mesh, no collective"
    split = (f"batch {batch} split over data ({dp})" if batch % dp == 0
             else f"batch {batch} whole on every data rank ({dp} does not "
                  "divide it)")
    data = (f"and over data ({dp}) on embed, embed_r, moe_in, moe_out, "
            + ("gathered over data at use" if route == "weights" else
               "kept sharded over data at use (the activation-gathered "
               "route: each product's rows gathered over data, its "
               "d-partials summed back or its columns sent home by one "
               "all-to-all)") if fsdp else
            "and not over data (serving weights below the inference "
            "threshold)")
    ep = os.environ.get("REPRO_MOE_MODE") == "ep_model"
    experts = ("the routed experts expert-parallel (E / model experts a "
               "rank at the whole hidden dim; gathered whole where model "
               "does not divide E)" if ep else
               "the routed experts' hidden dim")
    reduce = ("; row-parallel partials summed in bf16 (REPRO_BF16_REDUCE)"
              if os.environ.get("REPRO_BF16_REDUCE") else "")
    return (f"production (ZeRO-3 over data, tensor parallel over model): "
            f"params sharded over model ({mp}) on heads, kv_heads, mlp, "
            f"vocab, inner, experts_mdl {data}, a leaf whole under these "
            f"over model as the PartitionPlan; attention, MLA, SwiGLU, "
            f"{experts}, Mamba-2's SSD heads and the vocabulary parallel "
            f"over model, the leaves whole under the tables gathered whole "
            f"at use{reduce}; "
            f"{split}; KV caches by kv head and SSM caches by SSD head over "
            f"model, MLA's latent cache whole over model"
            + (f"; KV and latent caches' sequence over {cache_seq} (segment "
               f"attention merged over {cache_seq}, the ring rolled across "
               f"segments)" if cache_seq else ""))


# ---------------------------------------------------------------------------
# Parameter / optimizer / cache specs
# ---------------------------------------------------------------------------

def _rule_shards(spec, mesh, rules, dtype) -> Tuple[Any, Any]:
    """(this rank's meta shards, (data dim, model dim) tree) of a param
    spec tree under a rule table (whole leaves without a mesh)."""
    shapes: Dict = {}
    dims: Dict = {}
    for path, p in params_lib.leaves(spec):
        d = ((None, None) if mesh is None else
             shlib.stored_layout(p.shape, p.axes, rules, mesh))
        params_lib._set(shapes, path,
                        _meta(shlib.local_shape(p.shape, d, mesh), dtype))
        params_lib._set(dims, path, d)
    return shapes, dims


def inference_fsdp(cfg: ArchConfig, mesh, fsdp: bool = False) -> bool:
    """Whether serving weights shard over "data" too: asked for, or bf16
    weights over "model" alone above ``INFERENCE_FSDP_THRESHOLD`` bytes a
    rank (the reference's ``param_specs(train=False)``)."""
    return fsdp or (2.0 * cfg.n_params() / mesh_lib.mesh_mp(mesh)
                    > INFERENCE_FSDP_THRESHOLD)


def param_specs(cfg: ArchConfig, mesh, *, train: bool, fsdp: bool = True
                ) -> Tuple[Any, Any]:
    """(meta params tree of this rank's shards, (data dim, model dim)
    tree) for the backbone in bf16 under ``param_rules``; at inference
    (``train=False``) without ``fsdp`` the weights shard over "data" only
    above the threshold (:func:`inference_fsdp`)."""
    if not train:
        fsdp = inference_fsdp(cfg, mesh, fsdp)
    rules = None if mesh is None else shlib.param_rules(mesh, fsdp=fsdp,
                                                        train=train)
    return _rule_shards(Backbone(cfg).spec(), mesh, rules, BF16)


def _state(p_shapes) -> optim.AdamWState:
    f32 = lambda t: _meta(t.shape, F32)
    return optim.AdamWState(
        step=torch.zeros((), dtype=I32),        # the host step counter
        mu=_map(p_shapes, f32), nu=_map(p_shapes, f32))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def train_state_specs(cfg: ArchConfig, mesh, *, fsdp: bool = True):
    """(meta ``TrainState``, (data dim, model dim) tree of its params):
    bf16 params, f32 moments mirroring them, the step counter on the
    host."""
    p_shapes, p_dims = param_specs(cfg, mesh, train=True, fsdp=fsdp)
    return tasks.TrainState(params=p_shapes, opt=_state(p_shapes)), p_dims


def _rules(mesh, fsdp: bool, activations: bool = False
           ) -> Optional[shlib.Rules]:
    """The production layout's rules (None without a mesh), on the
    activation-gathered route with ``activations``."""
    return (None if mesh is None else
            shlib.production_rules(mesh, fsdp=fsdp, activations=activations))


def step_route(shape: InputShape) -> str:
    """The route a step of ``shape`` takes (``Rules.route``): decode
    always takes the activation-gathered route, as the reference's
    ``set_param_gather(None)`` at decode; train and prefill under
    ``REPRO_NO_WEIGHT_GATHER``."""
    return ("activations" if shape.kind == "decode"
            or shlib.no_weight_gather() else "weights")


def cache_rules(cfg: ArchConfig, shape: InputShape, mesh, *,
                fsdp: bool = False, activations: bool = False
                ) -> Optional[shlib.Rules]:
    """The production rules of a decode step of ``shape``, their cache
    entries the reference's (``repro/launch/specs.py`` ``cache_specs``):
    the cache's sequence over "data" only when the batch cannot use the
    data axis, the batch rule dropped then, and ``REPRO_CACHE_SEQ_SHARD``
    naming the sequence's axis when set.  Every cache leaf is checked as
    the reference's ``NamedSharding`` checks it
    (``sharding.check_cache_leaf``: ``CacheLayoutError`` where one axis
    lands on two dims); the sequence rule is then dropped where its axis
    does not divide the cache length or has one rank, as the reference's
    ``leaf`` drops it; ``activations``: on the activation-gathered
    route.  None without a mesh."""
    if mesh is None:
        return None
    batch = shape.global_batch
    cache_len = tasks.effective_cache_len(cfg, shape)
    # shard cache seq over data only when the batch can't use the data axis
    b_ax = shlib.batch_axes(mesh)
    batch_shardable = shlib.divisible(batch, mesh, b_ax)
    rules = shlib.production_rules(mesh, fsdp=fsdp,
                                   seq_shard=not batch_shardable,
                                   activations=activations)
    if not batch_shardable:
        rules.arules["batch"] = None
    # sequence-sharded flash-decode: the decode caches' sequence over the
    # axis the knob names (the reference's memory-capacity lever)
    if os.environ.get("REPRO_CACHE_SEQ_SHARD"):
        rules.arules["cache_seq"] = os.environ["REPRO_CACHE_SEQ_SHARD"]
    map_cache_spec(lambda sa, name: shlib.check_cache_leaf(
        name, sa[0], sa[1], rules.arules, mesh),
        Backbone(cfg).cache_specs(batch, cache_len))
    ax = rules.arules["cache_seq"]
    if ax is not None and (shlib.axis_size(mesh, ax) <= 1 or
                           not shlib.divisible(cache_len, mesh, ax)):
        rules.arules["cache_seq"] = None
    return rules


def cache_specs(cfg: ArchConfig, shape: InputShape, mesh,
                rules: Optional[shlib.Rules] = None):
    """The caches ``tasks.init_caches`` preallocates for this rank's rows,
    kv heads, SSD heads, conv channels and sequence segment of a decode
    shape (bf16, the SSM state f32), on meta, under ``rules``
    (:func:`cache_rules` by default)."""
    if rules is None:
        rules = cache_rules(cfg, shape, mesh)
    with shlib.param_gather(mesh, rules):
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

def _on_mesh(fn, mesh, rules: Optional[shlib.Rules]):
    """``fn`` run under the mesh's gather context with ``rules`` (``fn``
    itself without a mesh: the single-device path)."""
    if mesh is None:
        return fn

    def run(*args):
        with shlib.param_gather(mesh, rules):
            return fn(*args)
    return run


def build_step(cfg: ArchConfig, shape: InputShape, mesh,
               opt_cfg: Optional[OptimConfig] = None):
    """Returns ``(fn, args)``: the port's own step for ``shape.kind``
    (``tasks.make_train_step`` with per-block remat, ``make_prefill_step``
    or ``make_decode_step``) under the production layout on the route
    :func:`step_route` names, and this rank's meta arguments;
    ``fn(*args)`` runs it."""
    opt_cfg = opt_cfg or OptimConfig()
    window = tasks.effective_window(cfg, shape)
    batch = input_specs(cfg, shape, mesh)
    act = step_route(shape) == "activations"
    if shape.kind == "train":
        step = tasks.make_train_step(cfg, opt_cfg, window=window, remat=True)
        state, _ = train_state_specs(cfg, mesh)
        return _on_mesh(step, mesh, _rules(mesh, True, act)), (state, batch)
    params, _ = param_specs(cfg, mesh, train=False, fsdp=False)
    fsdp = mesh is not None and inference_fsdp(cfg, mesh)
    if shape.kind == "prefill":
        step = tasks.make_prefill_step(cfg, window=window)
        return _on_mesh(step, mesh, _rules(mesh, fsdp, act)), (params, batch)
    step = tasks.make_decode_step(cfg, window=window)
    rules = cache_rules(cfg, shape, mesh, fsdp=fsdp, activations=True)
    caches = cache_specs(cfg, shape, mesh, rules)
    # the token after a full cache: the ring's last slot at a window
    pos = tasks.effective_cache_len(cfg, shape) - 1
    return _on_mesh(step, mesh, rules), (params, caches, batch["token"], pos)


# ---------------------------------------------------------------------------
# Flow-RL (paper pipeline) dry-run step: one GRPO update on trajectories
# ---------------------------------------------------------------------------

def build_flow_step(cfg: ArchConfig, mesh, *,
                    num_steps: int = 10, latent_tokens: int = 1024,
                    latent_dim: int = 16, cond_len: int = 16,
                    cond_dim: int = 512, group_size: int = FLOW_GROUP,
                    prompts: int = FLOW_PROMPTS, fsdp: bool = True):
    """The paper's own training step (the ``FlowGRPOTrainer`` update: the
    GRPO loss over every SDE step, its backward, the gradients' mesh
    reduction, clip and AdamW) at production scale, under the reference's
    FSDP rules (``repro/launch/specs.py:257``); ``fsdp=False``: the
    trainers' own layout (the ``PartitionPlan``).  Under
    ``REPRO_NO_WEIGHT_GATHER`` the rules take the activation-gathered route
    (``BaseTrainer.layout_plan`` reads the switch).  Returns ``(fn, (state,
    traj, adv))``; the trainer is built without params or reward towers
    (``__new__``, as the reference does), its state being the meta
    argument."""
    from repro_torch import registry
    from repro_torch.core import schedulers
    from repro_torch.core.rollout import Trajectory
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
    tr._spec, tr._dp, tr._mp = spec, dp, mp
    tr.plan, tr._rules, tr._sharded = FlowGRPOTrainer.layout_plan(
        mesh, spec, fsdp and mesh is not None)
    if mesh is not None:
        tr._dgroup = mesh_lib.data_group(mesh)
        tr._mgroup = mesh_lib.model_group(mesh)
    tr._row_cache, tr._draw_rows = {}, None
    tr._engine, tr._fused = None, None
    tr.optimizer = registry.build("optimizer", opt_cfg.optimizer)
    tr._lr = optim.make_schedule(opt_cfg)
    tr._scalars = optim.step_scalars(META)
    p_shapes = params_lib.shape_tree(spec, BF16)
    if tr.plan is not None:
        p_shapes = tr.plan.shard_state(p_shapes)
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

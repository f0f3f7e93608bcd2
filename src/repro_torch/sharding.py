"""Logical-axis rule tables, the gather context that lays params out at
use, tensor parallelism over "model", and the collectives the distributed
path uses — the counterpart of ``repro.sharding``.

**Rule tables** (``batch_axes``, ``param_rules``, ``act_rules``,
``gathered_param_rules``, ``pspec``): the reference's tables key for key,
as plain tuples of mesh-axis names (no ``PartitionSpec``).  A mesh is the
port's ``DeviceMesh`` (``mesh_dim_names``) or anything with the
reference's ``axis_names`` and ``shape`` mapping.  :func:`leaf_layout`
gives a leaf its (data dim, model dim) under a table, dropping a sharding
that the axis does not divide (the reference's ``launch/specs.py:66-72``)
or whose axis has one rank; :func:`stored_layout` is the same for
storage, where a leaf the table leaves whole on every rank is split over
"model" as the trainers split it.  Storage, the gather and the dry run
all read these two.

**Two layouts, the second with two routes.**  ``param_gather(mesh)``
with no rules is the trainers'
ZeRO-3 over "model": params stored sharded by the ``PartitionPlan``
(``model_shard_dim``), each layer's slice all-gathered whole over the
"model" group before use (``GatherParam``) and its gradient
reduce-scattered back (then / mp: the ranks of the group run the same
batch), so every kernel sees whole weights.  ``param_gather(mesh,
rules)`` with :func:`production_rules` is the reference's production
layout:

* storage by ``rules.stored`` (``param_rules``, :func:`stored_layout`): a
  leaf's "data" dim split by dp and its "model" dim by mp; a leaf the
  reference keeps whole on every rank is split over "model" on the dim
  the trainers' ``PartitionPlan`` picks and gathered whole at use (a
  difference by construction: no leaf takes more of a rank than under
  the trainers' layout);
* at use (``rules.prules``, ``gathered_param_rules``) ``constrain_params``
  all-gathers the "data" dim over the data group; its backward is a
  reduce-scatter mean over "data", which is the data-parallel gradient
  (the data ranks hold different batches);
* the "model" dim stays sharded: attention, MLA, the SwiGLU MLP, the
  routed and shared experts and the vocabulary run tensor-parallel with
  Megatron's two operators, :func:`copy_to_model` (*f*: identity
  forward, all-reduce over "model" backward) and
  :func:`reduce_from_model` (*g*: all-reduce forward, identity
  backward): each rank's row-parallel product stays f32
  (``models/layers.row_parallel``) and *g* sums it in place and rounds
  once, as the reference's ``reduce_dtype`` accumulates; under
  ``REPRO_BF16_REDUCE`` (``models/layers.reduce_dtype``) each rank rounds
  its partial to bf16 and *g* sums bf16, half the bytes;
* under ``REPRO_MOE_MODE=ep_model`` the routed experts' tables are laid
  out as the reference lays them at use: experts over "model"
  (``experts_mdl``, rank r holding [r·E/mp, (r+1)·E/mp)) at the whole
  hidden dim (``moe_f``), their ``moe_in`` / ``moe_out`` dims gathered
  over "data".  Each rank runs its experts' slots (``models/moe.py``,
  expert parallel).  The reference moves its (G, E, C, d) dispatch
  buffer to the experts' ranks and gathers the results back around the
  expert products; its token rows are replicated over "model" (the batch
  splits over "pod" / "data" only), so the first move is a local slice
  and the second an all-gather of G·E·C·d values.  The port's rows are
  replicated over "model" too, so each rank fills its own experts' slots
  from the rows it holds, and its f32 gated sum joins the shared
  experts' partial in the one *g* tensor mode runs (a difference by
  construction: the layout is the reference's, the collective is *g*;
  no all-to-all, no buffer, no gather of results);
* the expert tables' ``moe_in`` / ``moe_out`` dims, which the
  reference's ``gathered_param_rules`` keeps sharded over "data" at use
  in tensor and dense modes (XLA then moves the token rows), are
  gathered over "data" like every other leaf (``DATA_GATHERED_AXES``, a
  difference by construction: the port's dispatch is local to a rank's
  rows);
* the Mamba-2 blocks run tensor-parallel over their SSD heads where the
  axis divides the heads and the state (``models/ssm.py``): ``in_proj``,
  the conv, the gated norm and ``out_proj`` at a rank's heads, x through
  *f*, ``out_proj``'s partial sums through *g*.  Their packed leaves
  (``in_proj``'s z, x, B, C, dt; the conv's x, B, C: ``P.parts``) are
  stored with each component's slice of the rank (:func:`pack_cut`), the
  reference's shard shape in component order.  Every head reads all of B
  and C (one state group), so the block gathers their columns of
  ``in_proj`` and the conv over "model" (:func:`gather_model_sum`, route
  (a): d_model × 2N values a layer, where *f* on the (B, L, 2N)
  activations would all-reduce those in the backward); a rank's gradient
  of them is its heads' part, so the gather's backward sums over "model"
  where ``GatherParam``'s means.  The gated RMSNorm spans the whole inner
  width: each rank's sum of squares is all-reduced over "model" forward
  and backward (:func:`sum_over_model`);
* the parts in ``GATHERED_WHOLE`` are not tensor-parallel: their "model"
  dim is gathered too, as in the trainers' layout (the routed experts
  under ``ep_model`` where the axis does not divide E, and a Mamba-2
  block whose heads or state the axis does not divide), a packed leaf
  put back in canonical order (:func:`unpack`);
* on the activation-gathered route (``Rules.route == "activations"``,
  :func:`production_rules` with ``activations``: the reference's
  ``set_param_gather(None)``, at decode always and under
  ``REPRO_NO_WEIGHT_GATHER``, :func:`no_weight_gather`) every matrix
  keeps its stored "data" shard at use (:func:`use_layout`; the vectors
  are still gathered, ``DATA_GATHERED_AXES`` retired), and each product
  moves rows over "data" instead (:class:`RowGroup`, :func:`rows_for`).
  The input side (the "data" dim is the contraction: :func:`rows_in`)
  gathers every rank's rows, multiplies this rank's d-columns of them by
  its shard and reduce-scatters the d-partial, in the dtype ``prod``
  gives it (``models/layers.reduce_dtype``), back onto the rank's rows;
  the output side (:func:`rows_out`) multiplies the gathered rows by its
  shard and sends each row's d / n columns home by one all-to-all
  (:func:`rows_home`).  Each backward is the forward's mirror (an
  all-gather for a reduce-scatter, an all-to-all back for the
  gather-and-cut and for the all-to-all, a reduce-scatter for the
  output side's gather), and a weight's gradient, summed over every
  rank's rows, is divided by n once: the data-parallel mean, which
  :func:`mesh_grads` then leaves alone.  Where every rank holds every
  row (a batch the data axis does not divide: the rules' ``batch`` entry
  dropped) the d-partials are all-reduced and the columns all-gathered;
* ``rules.arules`` (``act_rules``) lays out the decode caches: kv heads,
  and the SSM caches' heads and conv channels (x, B, C each by rank), over
  "model" where the axis divides them, and an attention or latent cache's
  sequence over the axis its ``cache_seq`` entry names (the reference's
  rule, ``launch/specs.py``'s ``cache_rules``: "data" when the batch does
  not divide the data axis, or the axis ``REPRO_CACHE_SEQ_SHARD`` names).
  Rank r of that axis holds positions [r·T/n, (r+1)·T/n) of the ring
  (:func:`current_seq`, :func:`seq_segment`); a layout that puts one mesh
  axis on two dims of a cache leaf is refused (:func:`check_cache_leaf`,
  ``CacheLayoutError``), as the reference's ``NamedSharding`` refuses it.

With no mesh, or a mesh whose axes are 1, nothing is gathered and no
operator runs: the layouts compute the single-device function, bit for
bit on one rank.  :func:`mesh_grads` is the gradients' reduction after a
backward under either layout, and gives the clip the groups each leaf's
pieces are spread over, so the global norm counts every element once.

Every collective the port issues goes through a function here, and each
one reports its kind, result bytes and group size to the recorders in
``COLLECTIVE_HOOKS`` (empty unless ``launch.hlo_stats.record_collectives``
is active), so one recorder sees the whole step.  Collectives pick
``all_gather_single`` / ``reduce_scatter_single`` where torch has them
and the ``*_tensor`` names (deprecated there, the only ones in older
releases) otherwise.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import (Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

import torch
import torch.distributed as dist

from repro_torch.models.params import P, _set, leaves, model_shard_dim

F32 = torch.float32

Axes = Tuple[Optional[str], ...]
RuleTable = Dict[str, Union[str, Tuple[str, ...], None]]


class Rules(NamedTuple):
    """The production layout's three tables and its route: ``"weights"``
    (each matrix's "data" shard gathered at use) or ``"activations"``
    (the matrices keep it; each product gathers its rows,
    :func:`rows_in` / :func:`rows_out`)."""
    prules: RuleTable       # params at use (gathered_param_rules)
    arules: RuleTable       # activations and caches (act_rules)
    stored: RuleTable       # params in storage (param_rules)
    route: str = "weights"


class TP(NamedTuple):
    """The "model" group a tensor-parallel block reduces over."""
    group: object
    size: int
    rank: int


class SeqGroup(NamedTuple):
    """The mesh axis a decode cache's sequence is split over: rank ``rank``
    of ``size`` holds the ``rank``-th contiguous segment of the ring."""
    axis: str
    group: object
    size: int
    rank: int


class RowGroup(NamedTuple):
    """The "data" group of the activation-gathered route: ``split`` when
    each rank holds its own 1/``size`` of the rows, else (a batch the
    axis does not divide) every rank holds them all."""
    group: object
    size: int
    rank: int
    split: bool


class CacheLayoutError(ValueError):
    """A cache layout that maps one mesh axis to two dims of one leaf (the
    reference's ``DuplicateSpecError``)."""


_CTX: Dict = {"mesh": None, "rules": None, "tp": None, "seq": None,
              "rows": None}

# callables ``hook(kind, result_bytes, group_size)``, one call per
# collective issued (the reference's HLO op names as kinds)
COLLECTIVE_HOOKS: List[Callable[[str, int, int], None]] = []

# The block parts that do not run parallel over "model": under the
# production rules their leaves are gathered whole at use (the "model" dim
# as well as the "data" dim), so every "model" rank computes them on the
# same rows.  Every other part keeps its "model" shard at use.  The
# backbone names "experts_undivided" only under ``REPRO_MOE_MODE=ep_model``
# where the "model" axis does not divide E (in tensor and dense modes the
# routed experts run tensor-parallel over their hidden dim, under ep_model
# expert-parallel, ``models/moe.py``) and "ssm_undivided" only where the
# "model" axis does not divide a Mamba-2 block's heads and state.
GATHERED_WHOLE: Dict[str, str] = {
    "ssm_undivided": "a Mamba-2 block whose SSD heads or state the 'model' "
                     "axis does not divide (models/ssm.py: splits): a "
                     "rank's heads would take uneven slices of the packed "
                     "in_proj, so it runs whole on every rank, as kv heads "
                     "that do not divide do",
    "experts_undivided": "ep_model where the 'model' axis does not divide "
                         "the routed experts (grok-1-314b's 8 over 16): the "
                         "reference drops a sharding its axis does not "
                         "divide (launch/specs.py:66-72) and so keeps every "
                         "expert, at the whole hidden dim, on every rank; "
                         "so does the port",
}

# Logical axes whose "data" shard the port gathers at use where the
# reference's ``gathered_param_rules`` keeps it (the expert tables' d_model
# dims in tensor and dense modes): kept sharded, a rank would have to send
# every token row it routes to each "data" rank, ≈ 4 GB a layer at
# deepseek-v2-236b's train_4k, where the gather moves the rank's f / mp
# slice of the experts, ≈ 0.5 GB.
DATA_GATHERED_AXES = ("moe_in", "moe_out")


# ---------------------------------------------------------------------------
# Mesh axes and rule tables
# ---------------------------------------------------------------------------

def _moe_mode() -> str:
    return os.environ.get("REPRO_MOE_MODE", "tensor")


def no_weight_gather() -> bool:
    """``REPRO_NO_WEIGHT_GATHER`` set to any non-empty value ("0" too, the
    reference's truthiness): the activation-gathered route."""
    return bool(os.environ.get("REPRO_NO_WEIGHT_GATHER"))


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (``DeviceMesh.mesh_dim_names`` or a
    reference-style ``axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """Ranks on the axis ``name`` (1 for no mesh or an absent axis)."""
    if mesh is None:
        return 1
    names = axis_names(mesh)
    if name not in names:
        return 1
    if hasattr(mesh, "mesh_dim_names"):
        return int(mesh.size(names.index(name)))
    return int(mesh.shape[name])


def _coord(mesh, name: str) -> int:
    return int(mesh.get_coordinate()[axis_names(mesh).index(name)])


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the batch dim is sharded over."""
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def param_rules(mesh, *, fsdp: bool = True, train: bool = True
                ) -> RuleTable:
    """Rules for parameter logical axes (``train`` is the reference's
    argument; its table does not read it)."""
    fsdp_axis = "data" if (fsdp and "data" in axis_names(mesh)) else None
    return {
        "embed": fsdp_axis,        # d_model rows of big matrices (zero-3)
        "embed_r": fsdp_axis,      # d_model as the output dim (w_down, wo)
        "heads": "model",
        "kv_heads": "model",
        "q_lora": None,
        "kv_lora": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": None,           # tensor/dense: experts replicated
        "experts_mdl": "model",    # ep_model: experts over the model axis
        "moe_f": None,
        "moe_in": fsdp_axis,
        "moe_out": fsdp_axis,
        "layers": None,
        "groups": None,
        "state": None,
        "conv": None,
        "inner": "model",          # ssm d_inner
        "ssm_heads": "model",
        "norm": None,
        "latent": None,
        "time": None,
    }


def act_rules(mesh, *, seq_shard: bool = False) -> RuleTable:
    """Rules for activation / cache logical axes."""
    b = batch_axes(mesh)
    return {
        "batch": b if b else None,
        "seq": None,
        "cache_seq": ("data" if (seq_shard and "data" in axis_names(mesh))
                      else None),
        "embed": None,
        "embed_r": None,
        "heads": "model",
        "kv_heads": "model",
        "kv_lora": None,
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": None,
        "experts_mdl": "model",
        "moe_f": None,
        "moe_in": None,
        "moe_out": None,
        "state": None,
        "inner": "model",
        "ssm_heads": "model",
        "latent": None,
        "cond": None,
        "group": None,
        "time": None,
        "scalar": None,
    }


def gathered_param_rules(mesh) -> RuleTable:
    """Layout of a weight slice while it is used: "model"-sharded axes
    stay sharded, the "data" shard is gathered, except the expert weights'
    ``moe_in`` / ``moe_out`` in tensor and dense modes (the reference
    keeps them sharded over "data"; the port gathers them,
    ``DATA_GATHERED_AXES`` and :func:`use_layout`)."""
    r = param_rules(mesh, fsdp=False)
    if _moe_mode() != "ep_model":
        stored = param_rules(mesh, fsdp=True)
        r["moe_in"] = stored["moe_in"]
        r["moe_out"] = stored["moe_out"]
    return r


def pspec(axes: Axes, rules: RuleTable) -> Tuple:
    """The mesh axes (or None) of each logical axis: the reference's
    ``PartitionSpec`` entries as a tuple."""
    return tuple(None if a is None else rules.get(a, None) for a in axes)


def production_rules(mesh, *, fsdp: bool = True, seq_shard: bool = False,
                     activations: bool = False) -> Rules:
    """The reference's production layout: params stored by
    ``param_rules(fsdp=fsdp)``, used by ``gathered_param_rules``,
    activations and caches by ``act_rules(seq_shard=seq_shard)``; with
    ``activations`` the activation-gathered route (the reference's
    ``set_param_gather(None)``)."""
    return Rules(prules=gathered_param_rules(mesh),
                 arules=act_rules(mesh, seq_shard=seq_shard),
                 stored=param_rules(mesh, fsdp=fsdp),
                 route="activations" if activations else "weights")


def divisible(n: int, mesh, names) -> bool:
    """Whether the mesh axes ``names`` (one name or a tuple; an axis the
    mesh lacks counts 1) divide ``n``: the reference's
    ``launch/specs.py`` ``_divisible``."""
    size = 1
    for a in (names if isinstance(names, tuple) else (names,)):
        size *= axis_size(mesh, a)
    return n % size == 0


def check_cache_leaf(name: str, shape: Tuple[int, ...], axes: Axes,
                     rules: RuleTable, mesh) -> None:
    """Check a cache leaf of canonical ``shape`` and logical ``axes`` as
    the reference's ``NamedSharding`` checks its ``PartitionSpec``
    (``launch/specs.py``'s ``cache_specs.leaf``: each axis's rule,
    dropped where the mesh axes do not divide the dim): raises
    ``CacheLayoutError`` naming the leaf and the axis where one mesh axis
    lands on two dims, or a rule names an axis the mesh lacks."""
    seen = {}
    for i, (ax, n) in enumerate(zip(axes, shape)):
        m = rules.get(ax) if ax else None
        if m is not None and not divisible(n, mesh, m):
            m = None
        for a in (m if isinstance(m, tuple) else (m,)):
            if a is None:
                continue
            if a not in axis_names(mesh):
                raise CacheLayoutError(
                    f"cache leaf {name!r}: {ax!r} names mesh axis {a!r}, "
                    f"which the mesh {axis_names(mesh)} lacks")
            if a in seen:
                raise CacheLayoutError(
                    f"cache leaf {name!r} {tuple(shape)}: mesh axis {a!r} "
                    f"would shard both dim {seen[a]} ({axes[seen[a]]}) and "
                    f"dim {i} ({ax})")
            seen[a] = i


def leaf_layout(shape: Tuple[int, ...], axes: Axes, rules: RuleTable,
                mesh) -> Tuple[Optional[int], Optional[int]]:
    """(data dim, model dim) of a leaf of canonical ``shape`` and logical
    ``axes`` under ``rules``: the dims the table maps to "data" and to
    "model", each dropped where that axis's size does not divide the dim
    or is 1 (a one-rank axis shards nothing)."""
    data = model = None
    for i, (ax, n) in enumerate(zip(axes, shape)):
        m = rules.get(ax) if ax else None
        if m is None:
            continue
        names = m if isinstance(m, tuple) else (m,)
        size = math.prod(axis_size(mesh, a) for a in names)
        if size <= 1 or n % size:
            continue
        if "data" in names:
            data = i
        if "model" in names:
            model = i
    return data, model


def local_shape(shape: Tuple[int, ...], dims: Tuple[Optional[int],
                                                    Optional[int]],
                mesh) -> Tuple[int, ...]:
    """This rank's shard of a leaf of ``shape`` laid out as ``dims``."""
    s = list(shape)
    for d, name in zip(dims, ("data", "model")):
        if d is not None:
            s[d] //= axis_size(mesh, name)
    return tuple(s)


def packed(parts: Tuple[int, ...], shape: Tuple[int, ...],
           dim: Optional[int], n: int) -> bool:
    """Whether a leaf whose last dim packs components of widths ``parts``
    (``P.parts``) and is split ``n`` ways on ``dim`` is cut component by
    component: ``dim`` is that last dim and ``n`` divides every width.
    Otherwise the cut is a contiguous slice, as for any leaf."""
    return (bool(parts) and dim is not None and dim == len(shape) - 1
            and n > 1 and all(w % n == 0 for w in parts))


def pack_columns(parts: Tuple[int, ...], n: int, r: int) -> List[int]:
    """The canonical indices, along the packed dim, of rank ``r``'s shard
    of ``n``: the r-th ``1/n`` of each component, in component order."""
    out: List[int] = []
    start = 0
    for w in parts:
        k = w // n
        out.extend(range(start + r * k, start + (r + 1) * k))
        start += w
    return out


def pack_cut(t: torch.Tensor, dim: int, parts: Tuple[int, ...], n: int,
             r: int) -> torch.Tensor:
    """Rank ``r``'s shard of ``t`` packed along ``dim`` (a new tensor)."""
    pieces, start = [], 0
    for w in parts:
        k = w // n
        pieces.append(t.narrow(dim, start + r * k, k))
        start += w
    return torch.cat(pieces, dim)


def unpack(t: torch.Tensor, dim: int, parts: Tuple[int, ...], n: int
           ) -> torch.Tensor:
    """The canonical order of ``t``, the ``n`` ranks' packed shards
    concatenated along ``dim`` (rank order): each component's ``n`` slices
    put back together, component after component."""
    shards = torch.chunk(t, n, dim)
    out, start = [], 0
    for w in parts:
        k = w // n
        out += [s.narrow(dim, start, k) for s in shards]
        start += k
    return torch.cat(out, dim)


def stored_layout(shape: Tuple[int, ...], axes: Axes, rules: RuleTable,
                  mesh) -> Tuple[Optional[int], Optional[int]]:
    """(data dim, model dim) of a leaf in storage under the table
    ``rules``: :func:`leaf_layout`, except that a leaf the table leaves
    whole on every rank (no axis it maps divides, as 56 heads over 16, or
    none is mapped, as a norm scale when serving) is split over "model"
    as the trainers' ``PartitionPlan`` splits it (``model_shard_dim``) and
    gathered whole at use.  So no leaf holds more of a rank than under the
    trainers' ZeRO-3 over "model", where the reference keeps it whole."""
    d, m = leaf_layout(shape, axes, rules, mesh)
    if d is None and m is None:
        m = model_shard_dim(shape, axes, axis_size(mesh, "model"))
    return d, m


def use_layout(shape: Tuple[int, ...], axes: Axes, rules: Rules, mesh,
               part: Optional[str] = None
               ) -> Tuple[Optional[int], Optional[int]]:
    """(data dim, model dim) of a leaf while it is used under the
    production ``rules``: :func:`leaf_layout` under ``rules.prules``,
    except that a dim on an axis of ``DATA_GATHERED_AXES`` is gathered
    over "data" and a leaf of a ``GATHERED_WHOLE`` ``part`` is gathered
    whole.  On the activation-gathered route a matrix (two dims or more)
    keeps its stored "data" dim, those too."""
    route = rules.route == "activations" and len(shape) > 1
    if route:
        kept = stored_layout(shape, axes, rules.stored, mesh)[0]
    if part is not None:
        if part not in GATHERED_WHOLE:
            raise KeyError(f"{part!r} is not in GATHERED_WHOLE")
        return (kept if route else None), None
    d, m = leaf_layout(shape, axes, rules.prules, mesh)
    if d is not None and axes[d] in DATA_GATHERED_AXES:
        d = None
    return (kept if route else d), m


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _note(kind: str, result: torch.Tensor, group, n: int = 0) -> None:
    if COLLECTIVE_HOOKS:
        nbytes = result.numel() * result.element_size()
        g = n or dist.get_world_size(group)
        for hook in COLLECTIVE_HOOKS:
            hook(kind, nbytes, g)


def _all_gather_fn():
    return (getattr(dist, "all_gather_single", None)
            or dist.all_gather_into_tensor)


def _reduce_scatter_fn():
    return (getattr(dist, "reduce_scatter_single", None)
            or dist.reduce_scatter_tensor)


def gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Concatenate the ``n`` ranks' ``x`` along ``dim`` (rank order)."""
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _all_gather_fn()(out, src, group=group)
    _note("all-gather", out, group, n)
    return out.movedim(0, dim).contiguous() if dim else out


def scatter_mean_dim(x: torch.Tensor, dim: int, group, n: int,
                     mean: bool = True) -> torch.Tensor:
    """This rank's ``1/n`` chunk along ``dim`` of the mean (``mean``, else
    the sum) over the ``n`` ranks of ``x``: reduce-scattered in f32 and
    cast back."""
    out = reduce_scatter_dim(x.to(F32), dim, group, n)
    if mean:
        out.div_(n)
    return out.to(x.dtype)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, n: int
                       ) -> torch.Tensor:
    """This rank's ``1/n`` chunk along ``dim`` of the sum over the ``n``
    ranks of ``x``, in ``x``'s dtype."""
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _reduce_scatter_fn()(out, src, group=group)
    _note("reduce-scatter", out, group, n)
    return out.movedim(0, dim).contiguous() if dim else out


def all_gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` concatenated along dim 0."""
    return gather_dim(x, 0, group, n)


def all_reduce_mean(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """Mean over the group's ranks, in f32 (a new tensor of ``x``'s
    dtype)."""
    y = x.detach().to(F32, copy=True)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    _note("all-reduce", y, group, n)
    return y.div_(n).to(x.dtype)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks, in f32 (a new tensor of ``x``'s
    dtype)."""
    return all_reduce_sum_(x.detach().to(F32, copy=True), group).to(x.dtype)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    _note("all-reduce", y, group)
    return y


def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group's ranks, in place (``x`` is returned)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    _note("all-reduce", x, group)
    return x


class GatherParam(torch.autograd.Function):
    """Forward: the leaf gathered along ``dim`` from its shards over
    ``group``; backward: the gradient's mean over the group,
    reduce-scattered back to this rank's shard.  Over "model" (the ranks
    run the same batch) the mean is the gradient; over "data" (each rank
    its own rows) it is the data-parallel gradient."""

    @staticmethod
    def forward(ctx, shard, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return gather_dim(shard, dim, group, n)

    @staticmethod
    def backward(ctx, grad):
        return scatter_mean_dim(grad, ctx.dim, ctx.group, ctx.n), None, \
            None, None


class _GatherSumOverModel(torch.autograd.Function):
    """Forward: ``x`` gathered along ``dim`` from the "model" group;
    backward: this rank's chunk of the gradient summed over the group (a
    weight each rank uses on its own heads, so that each holds a part of
    its gradient)."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, grad):
        return scatter_mean_dim(grad, ctx.dim, ctx.group, ctx.n,
                                mean=False), None, None, None


class _SumOverModel(torch.autograd.Function):
    """Forward and backward: the sum over the "model" group (f32, cast
    back).  A statistic every rank's slice adds to and every rank reads:
    the gradient of a rank's part is the sum of the ranks' gradients of
    the total (*g*, then *f*)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity forward; backward the gradient summed over
    the "model" group (f32, cast back)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: forward the partial outputs summed over the "model"
    group (f32, cast back); backward identity."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class Partial(NamedTuple):
    """A rank's row-parallel partial sum for *g*, in the dtype *g* sums
    it in (f32, or bf16 under ``REPRO_BF16_REDUCE``:
    ``models/layers.reduce_dtype``): ``value``, the tensor (no gradient)
    or a function that computes it when *g* runs, and ``carrier``, zeros
    of its shape in the activation dtype with no storage, by which the
    gradient, in that dtype, enters the product that made it
    (``models/layers.row_parallel``).  So no f32 copy of the gradient is
    made (an f32 autograd input to *g* would have autograd upcast its
    gradient), and a checkpoint's rerun, which stops once the backward's
    saved tensors are back, stops before the product."""
    value: object
    carrier: torch.Tensor

    def tensor(self) -> torch.Tensor:
        """The partial (computed, where ``value`` is a function)."""
        return self.value() if callable(self.value) else self.value

    def reshape(self, *shape) -> "Partial":
        return Partial(lambda: self.tensor().reshape(*shape),
                       self.carrier.reshape(*shape))


def carrier(value: torch.Tensor, dtype) -> torch.Tensor:
    """Zeros of ``value``'s shape in ``dtype``, no storage (a
    :class:`Partial`'s carrier)."""
    return torch.zeros((), dtype=dtype, device=value.device).expand(
        value.shape)


class _ReducePartials(torch.autograd.Function):
    """*g* over :class:`Partial` sums: forward the partials' values added
    in place, summed over the "model" group in place in their dtype and
    cast to ``dtype``; backward the gradient, in ``dtype``, to each
    carrier."""

    @staticmethod
    def forward(ctx, group, dtype, value, *carriers):
        ctx.n = len(carriers)
        return all_reduce_sum_(value, group).to(dtype)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, None) + (grad,) * ctx.n


class _MeanOverData(torch.autograd.Function):
    """Forward: the mean over the "data" group (f32, cast back); backward:
    identity.  Each data rank's gradient then carries its rows' share of
    a statistic of every rank's rows, and the data mean of the ranks'
    gradients is the one-device gradient."""

    @staticmethod
    def forward(ctx, x, group, n):
        return all_reduce_mean(x, group, n)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def mean_over_data(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the installed mesh's "data" ranks (``x``
    itself with no mesh or one data rank): a statistic of this rank's
    rows made the statistic of the whole batch (equal rows a rank)."""
    mesh = _CTX["mesh"]
    n = axis_size(mesh, "data")
    if n <= 1:
        return x
    return _MeanOverData.apply(x, mesh.get_group("data"), n)


def copy_to_model(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """*f*: ``x`` entering a tensor-parallel region (an activation, or a
    weight that every "model" rank holds whole and uses on its own
    heads)."""
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x, tp: TP, dtype=None) -> torch.Tensor:
    """*g*: the sum of the "model" ranks' partial ``x``.  A tensor is
    summed in f32 and cast back to its dtype; a :class:`Partial`, or a
    tuple of them (their sum), is summed in place in the partials' dtype
    (f32, or bf16 under ``REPRO_BF16_REDUCE``) and cast once to
    ``dtype`` (the carriers' by default), the reference's
    ``reduce_dtype`` accumulation."""
    if isinstance(x, torch.Tensor):
        return _ReduceFromModel.apply(x, tp.group)
    parts = (x,) if isinstance(x, Partial) else tuple(x)
    with torch.no_grad():
        value = parts[0].tensor()
        for p in parts[1:]:
            value.add_(p.tensor())
    return _ReducePartials.apply(tp.group, dtype or parts[0].carrier.dtype,
                                 value, *(p.carrier for p in parts))


def gather_model_sum(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """The "model" ranks' ``x`` concatenated along ``dim``, its gradient
    summed over the ranks (``_GatherSumOverModel``)."""
    return _GatherSumOverModel.apply(x, dim % x.ndim, tp.group, tp.size)


def sum_over_model(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The sum of the "model" ranks' ``x``, its gradient the sum of the
    ranks' gradients (``_SumOverModel``)."""
    return _SumOverModel.apply(x, tp.group)


def gather_model(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """The "model" ranks' ``x`` concatenated along ``dim`` (no grad: the
    serving steps' logits)."""
    return gather_dim(x, dim % x.ndim, tp.group, tp.size)


# ---------------------------------------------------------------------------
# The activation-gathered route: rows over "data" around each product
# ---------------------------------------------------------------------------

def exchange(x: torch.Tensor, split: int, cat: int, group, n: int
             ) -> torch.Tensor:
    """One all-to-all: ``x`` cut into ``n`` chunks along ``split``, chunk
    j sent to rank j, and the chunks received concatenated along ``cat``
    (rank order)."""
    src = torch.stack(x.chunk(n, split), 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    _note("all-to-all", out, group, n)
    return torch.cat(out.unbind(0), cat)


def rows_gather(x: torch.Tensor, rows: RowGroup) -> torch.Tensor:
    """(..., R, K) -> (..., nR, K): every rank's rows (dim -2), in rank
    order; ``x`` itself when every rank holds them all."""
    return (gather_dim(x, x.ndim - 2, rows.group, rows.size) if rows.split
            else x)


def rows_sum(y: torch.Tensor, rows: RowGroup) -> torch.Tensor:
    """The sum over the ranks of partial ``y`` (..., nR, N) on this rank's
    rows, in ``y``'s dtype: a reduce-scatter over dim -2, or an
    all-reduce when every rank holds every row."""
    if rows.split:
        return reduce_scatter_dim(y, y.ndim - 2, rows.group, rows.size)
    return all_reduce_sum_(y.contiguous(), rows.group)


def rows_home(y: torch.Tensor, rows: RowGroup) -> torch.Tensor:
    """(..., nR, c) of this rank's c columns of every row -> (..., R, nc)
    of every column of its rows: one all-to-all (an all-gather of the
    columns when every rank holds every row)."""
    if rows.split:
        return exchange(y, y.ndim - 2, y.ndim - 1, rows.group, rows.size)
    return gather_dim(y, y.ndim - 1, rows.group, rows.size)


def rows_away(z: torch.Tensor, rows: RowGroup) -> torch.Tensor:
    """:func:`rows_home`'s inverse: (..., R, nc) -> (..., nR, c) (this
    rank's columns, sliced when every rank holds every row)."""
    if rows.split:
        return exchange(z, z.ndim - 1, z.ndim - 2, rows.group, rows.size)
    return my_cols(z, rows)


def my_cols(x: torch.Tensor, rows: RowGroup) -> torch.Tensor:
    """This rank's ``1/n`` of the last dim of ``x``."""
    k = x.shape[-1] // rows.size
    return x[..., rows.rank * k:(rows.rank + 1) * k]


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1])


class _RowsIn(torch.autograd.Function):
    """A product whose contraction dim is sharded over "data" (the input
    side: ``wq``, ``w_gate``, ``in_proj``, the LM head, ...): x (R, K)
    this rank's rows, w (K / n, N) its shard.  Forward: the rows gathered
    (:func:`rows_gather`), this rank's K / n columns of them times w in
    ``prod``'s dtype (the d-partial: ``layers.partial_product``, f32 or
    bf16 under ``REPRO_BF16_REDUCE``), summed back onto this rank's rows
    (:func:`rows_sum`) and cast once to x's dtype.  Backward, the mirror:
    the output gradient gathered, the columns' gradient sent home
    (:func:`rows_home`), and w's gradient, a sum over every rank's rows,
    divided by n (the data-parallel mean) when the ranks' rows differ."""

    @staticmethod
    def forward(ctx, x, w, rows, prod):
        xs = my_cols(rows_gather(x, rows), rows).contiguous()
        ctx.save_for_backward(xs, w)
        ctx.rows = rows
        return rows_sum(prod(xs, w), rows).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        xs, w = ctx.saved_tensors
        rows = ctx.rows
        gy = rows_gather(grad.contiguous(), rows)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = rows_home(gy.mm(w.t()), rows)
        if ctx.needs_input_grad[1]:
            dw = xs.t().mm(gy)
            if rows.split:
                dw.div_(rows.size)
        return dx, dw, None, None


class _RowsOut(torch.autograd.Function):
    """A product whose output dim is sharded over "data" (the output
    side: ``wo``, ``w_down``, ``out_proj``, ...): h (R, F) this rank's
    rows, w (F, D / n) its shard.  Forward: the rows gathered, times w,
    and each row's D / n columns sent home (:func:`rows_home`): (R, D) in
    h's dtype; with ``carry`` no value, zeros of that shape with no
    storage (a ``Partial``'s carrier, the value made by
    :func:`rows_out_value`).  Backward, the mirror: the gradient's columns
    sent back (:func:`rows_away`), the rows gathered again, h's gradient
    summed back onto this rank's rows (:func:`rows_sum`, f32), w's divided
    by n when the ranks' rows differ."""

    @staticmethod
    def forward(ctx, h, w, rows, carry):
        ctx.save_for_backward(h, w)
        ctx.rows = rows
        if carry:
            return torch.zeros((), dtype=h.dtype, device=h.device).expand(
                h.shape[0], w.shape[1] * rows.size)
        return rows_home(rows_gather(h, rows).mm(w), rows)

    @staticmethod
    def backward(ctx, grad):
        h, w = ctx.saved_tensors
        rows = ctx.rows
        gy = rows_away(grad.contiguous(), rows).contiguous()
        big = rows_gather(h, rows)
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = rows_sum(gy.mm(w.t()).to(F32), rows).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dw = big.t().mm(gy)
            if rows.split:
                dw.div_(rows.size)
        return dh, dw, None, None


def rows_in(x: torch.Tensor, w: torch.Tensor, rows: RowGroup, prod
            ) -> torch.Tensor:
    """``x @ w`` on the activation-gathered route, the contraction dim of
    ``w`` (K / n, N) this rank's shard of x's K (:class:`_RowsIn`)."""
    y = _RowsIn.apply(_flat(x), w, rows, prod)
    return y.view(*x.shape[:-1], w.shape[1])


def rows_out_value(h: torch.Tensor, w: torch.Tensor, rows: RowGroup, prod
                   ) -> torch.Tensor:
    """The value of ``h @ w`` on the output side of the route (w (F,
    D / n)), ``prod``'s dtype, no gradient: a rank's partial sum for *g*."""
    y = rows_home(prod(rows_gather(_flat(h), rows), w), rows)
    return y.view(*h.shape[:-1], y.shape[-1])


def rows_out(h: torch.Tensor, w: torch.Tensor, rows: RowGroup,
             carry: bool = False) -> torch.Tensor:
    """``h @ w`` on the output side of the route (:class:`_RowsOut`): the
    product in h's dtype, or with ``carry`` its carrier."""
    y = _RowsOut.apply(_flat(h), w, rows, carry)
    return y.view(*h.shape[:-1], y.shape[-1])


class _RowsHome(torch.autograd.Function):
    """:func:`rows_home` forward, :func:`rows_away` backward."""

    @staticmethod
    def forward(ctx, y, rows):
        ctx.rows = rows
        return rows_home(y, rows)

    @staticmethod
    def backward(ctx, grad):
        return rows_away(grad.contiguous(), ctx.rows).contiguous(), None


class _MeanGrad(torch.autograd.Function):
    """Identity forward; backward the gradient divided by ``n``."""

    @staticmethod
    def forward(ctx, w, n):
        ctx.n = n
        return w.view_as(w)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def lookup_rows(ids: torch.Tensor, w: torch.Tensor, rows: RowGroup, lookup
                ) -> torch.Tensor:
    """An embedding lookup on the route, the table ``w`` (V, D / n) this
    rank's columns: every rank's ``ids`` gathered, ``lookup(ids, w)``
    (autograd: the lookup, a mask, *g*), and each row's columns sent home
    (:class:`_RowsHome`); w's gradient divided by n when the ranks' rows
    differ."""
    lead = ids.shape
    if rows.split:
        ids = gather_dim(ids.contiguous(), 0, rows.group, rows.size)
        w = _MeanGrad.apply(w, rows.size)
    y = lookup(ids, w)
    return _RowsHome.apply(_flat(y), rows).view(*lead, -1)


# ---------------------------------------------------------------------------
# The gather context
# ---------------------------------------------------------------------------

def set_param_gather(mesh, rules: Optional[Rules] = None) -> None:
    """Install (or clear, with None) the gather context: without
    ``rules`` the trainers' ZeRO-3 over "model", with them (the
    reference's ``prules`` and ``arules`` and the storage table,
    :func:`production_rules`) the production layout."""
    if mesh is None:
        rules = None
    mp = axis_size(mesh, "model")
    _CTX["mesh"], _CTX["rules"] = mesh, rules
    _CTX["tp"] = (TP(mesh.get_group("model"), mp, _coord(mesh, "model"))
                  if rules is not None and mp > 1 else None)
    ax = None if rules is None else rules.arules.get("cache_seq")
    n = 1 if ax is None else axis_size(mesh, ax)
    _CTX["seq"] = (SeqGroup(ax, mesh.get_group(ax), n, _coord(mesh, ax))
                   if n > 1 else None)
    dp = axis_size(mesh, "data")
    _CTX["rows"] = (RowGroup(mesh.get_group("data"), dp, _coord(mesh, "data"),
                             "data" in (rules.arules.get("batch") or ()))
                    if rules is not None and rules.route == "activations"
                    and dp > 1 else None)


@contextlib.contextmanager
def param_gather(mesh, rules: Optional[Rules] = None):
    """Install the gather context for ``mesh`` (and rules) for the
    ``with`` body and restore the previous one after."""
    prev = dict(_CTX)
    set_param_gather(mesh, rules)
    try:
        yield
    finally:
        _CTX.update(prev)


def current_mesh():
    """The mesh of the installed gather context (None without one)."""
    return _CTX["mesh"]


def current_rules() -> Optional[Rules]:
    """The installed production rules (None: no mesh, or the trainers'
    layout)."""
    return _CTX["rules"]


def current_tp() -> Optional[TP]:
    """The installed "model" group of the production layout (None: no
    rules, or one "model" rank)."""
    return _CTX["tp"]


def tp_for(local: int, full: int) -> Optional[TP]:
    """The installed ``TP`` when a weight's ``local`` extent is a shard of
    ``full`` (the block runs tensor-parallel), None when it is whole."""
    if local == full:
        return None
    tp = _CTX["tp"]
    if tp is None or local * tp.size != full:
        raise RuntimeError(
            f"a {local}-wide shard of a {full}-wide weight outside the "
            "production layout's gather context")
    return tp


def rows_for(local: int, full: int) -> Optional[RowGroup]:
    """The installed route's ``RowGroup`` when a weight's ``local`` extent
    is its "data" shard of ``full`` (the product runs on the
    activation-gathered route), None when it is whole."""
    if local == full:
        return None
    rows = _CTX["rows"]
    if rows is None or local * rows.size != full:
        raise RuntimeError(
            f"a {local}-wide shard of a {full}-wide dim outside the "
            "activation-gathered route")
    return rows


def current_rows() -> Optional[RowGroup]:
    """The installed activation-gathered route's "data" group (None: the
    weights are gathered, or one "data" rank)."""
    return _CTX["rows"]


def current_seq() -> Optional[SeqGroup]:
    """The installed decode caches' sequence axis (None: the caches hold
    the whole ring)."""
    return _CTX["seq"]


def cache_extent(n: int, axis: str) -> int:
    """This rank's extent of a cache dim of size ``n`` on logical
    ``axis`` under the installed activation rules (kv heads, SSD heads
    and the SSM's conv channels over "model", the sequence over the
    ``cache_seq`` axis); ``n`` without them.  The rules that shard the
    sequence were built for a cache length that axis divides
    (``launch/specs.cache_rules`` drops the rule otherwise), so another
    length raises."""
    if axis == "cache_seq":
        seq = _CTX["seq"]
        if seq is None:
            return n
        if n % seq.size:
            raise CacheLayoutError(
                f"a {n}-entry cache under rules that split the sequence over "
                f"{seq.size} {seq.axis!r} ranks")
        return n // seq.size
    tp = _CTX["tp"]
    if tp is None or _CTX["rules"].arules.get(axis) != "model" or \
            n % tp.size:
        return n
    return n // tp.size


def seq_segment(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's contiguous segment along ``dim`` of a whole cache ``t``
    (a prefill's, which every rank of the sequence axis computed alike);
    ``t`` itself when the sequence is not split."""
    seq = _CTX["seq"]
    if seq is None:
        return t
    n = cache_extent(t.shape[dim], "cache_seq")
    return t.narrow(dim, seq.rank * n, n)


def _part_of(parts, key):
    if parts is None or isinstance(parts, str):
        return parts
    return parts.get(key)


def constrain_params(params, spec, mesh=None, rules: Optional[Rules] = None,
                     parts=None):
    """``params`` laid out for use.

    ``spec`` is the spec tree of ``params`` (:class:`P` leaves with the
    canonical shapes and logical axes; a layer's slice takes the unstacked
    block spec).  ``mesh`` and ``rules`` default to the installed
    context's (a block recomputed in the backward passes the ones its
    forward saw).  Without rules each leaf the ``PartitionPlan`` shards
    over "model" is gathered whole; identity with no mesh or a "model"
    axis of 1.  With rules each leaf's stored "data" shard is gathered and
    its "model" shard kept (:func:`use_layout`), except under the names of
    ``GATHERED_WHOLE`` in ``parts`` (a tree over ``params``' keys: a name
    applies to the subtree under it), whose "model" shard is gathered
    too."""
    if mesh is None:
        mesh, rules = _CTX["mesh"], _CTX["rules"]
    if rules is None:
        mp = axis_size(mesh, "model")
        if mp <= 1:
            return params
        group = mesh.get_group("model")

        def one(p, s: Optional[P]):
            if isinstance(p, dict):
                return {k: one(v, s[k]) for k, v in p.items()}
            dim = model_shard_dim(s.shape, s.axes, mp)
            if dim is None:
                return p
            return GatherParam.apply(p, dim, group, mp)

        return one(params, spec)

    def lay(p, s: P, part):
        if isinstance(p, dict):
            return {k: lay(v, s[k], _part_of(part, k)) for k, v in p.items()}
        d, m = stored_layout(s.shape, s.axes, rules.stored, mesh)
        ud, um = use_layout(s.shape, s.axes, rules, mesh, part)
        for dim, use, name in ((d, ud, "data"), (m, um, "model")):
            if dim is not None and use != dim:
                n = axis_size(mesh, name)
                p = GatherParam.apply(p, dim, mesh.get_group(name), n)
                if name == "model" and packed(s.parts, s.shape, dim, n):
                    p = unpack(p, dim, s.parts, n)
        return p

    return lay(params, spec, parts)


# ---------------------------------------------------------------------------
# Gradients after a backward
# ---------------------------------------------------------------------------

def mesh_grads(grads, spec, mesh, rules: Optional[Rules] = None
               ) -> Tuple[Dict, Dict]:
    """The gradients of a backward on a (data, model) mesh, reduced to
    the step's gradient, and the clip's layout (:func:`norm_layout`).

    Without rules (the trainers' ZeRO-3 over "model"): each averaged over
    "data" (f32), a leaf the ``PartitionPlan`` keeps whole averaged over
    "model" too (a sharded leaf's gradient was reduce-scattered by its
    gather).  With rules: a leaf stored sharded over "data" was averaged
    by its gather's reduce-scatter, or on the activation-gathered route
    by its products' backwards (each divides the sum over every rank's
    rows by n); every other leaf (tensor-parallel over
    "model", or replicated) is averaged over "data" only: its "model"
    ranks hold the same gradient (*f* summed the partial ones) or
    distinct pieces of it."""
    sharded = norm_layout(spec, mesh, rules)
    dp, mp = axis_size(mesh, "data"), axis_size(mesh, "model")
    dgroup, mgroup = mesh.get_group("data"), mesh.get_group("model")
    specs = dict(leaves(spec))
    out: Dict = {}
    for path, g in leaves(grads):
        s = specs[path]
        if rules is None:
            g = all_reduce_mean(g, dgroup, dp)
            if mp > 1 and path not in sharded:
                g = all_reduce_mean(g, mgroup, mp)
        elif stored_layout(s.shape, s.axes, rules.stored, mesh)[0] is None:
            g = all_reduce_mean(g, dgroup, dp)
        _set(out, path, g)
    return out, sharded


def norm_layout(spec, mesh, rules: Optional[Rules] = None) -> Dict:
    """The path of each leaf a rank holds a piece of, mapped to the
    groups the pieces are spread over ("model", then "data"), for
    ``optim.clip_by_global_norm``: without rules the ``PartitionPlan``'s
    sharded leaves over "model"; with rules each leaf's stored layout."""
    if mesh is None:
        return {}
    out = {}
    mp = axis_size(mesh, "model")
    dgroup, mgroup = mesh.get_group("data"), mesh.get_group("model")
    for path, s in leaves(spec):
        if rules is None:
            if model_shard_dim(s.shape, s.axes, mp) is not None:
                out[path] = (mgroup,)
            continue
        d, m = stored_layout(s.shape, s.axes, rules.stored, mesh)
        groups = tuple(grp for dim, grp in ((m, mgroup), (d, dgroup))
                       if dim is not None)
        if groups:
            out[path] = groups
    return out

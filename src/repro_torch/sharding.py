"""Weight-gathered FSDP for the port — the counterpart of
``repro.sharding``'s gather context (``set_param_gather``,
``constrain_params``), and the collectives the distributed path uses.

The reference stores params sharded over the "model" mesh axis and leaves
the in-layer layout to XLA's partitioner, which it steers with a
gathered-weight constraint on each layer's slice ("the MaxText
approach").  The port has no partitioner, so it fixes that layout to
gather-before-use (ZeRO-3): ``constrain_params`` all-gathers each sharded
leaf of a layer's slice over the "model" group in the forward
(``all_gather_into_tensor``) and reduce-scatters its gradient back to the
shard in the backward (``reduce_scatter_tensor``, then / mp: the ranks of
the group run the same batch, so the mean of their gradients is the
gradient).  Every kernel sees whole, local, contiguous tensors; the two
layouts compute the same function.

The context is installed per call (:func:`param_gather`) by whoever runs
the model on a mesh (the trainer, the serving engine); with no mesh, or a
mesh whose "model" axis is 1, ``constrain_params`` returns its input.
Which dim of a leaf is sharded is ``model_shard_dim`` of its canonical
shape and logical axes, so the gather agrees with the ``PartitionPlan``
that sharded it.  Collectives here pick ``all_gather_single`` /
``reduce_scatter_single`` where torch has them and the ``*_tensor`` names
(deprecated there, the only ones in older releases) otherwise.

Every collective the port issues goes through a function here, and each
one reports its kind, result bytes and group size to the recorders in
``COLLECTIVE_HOOKS`` (empty unless ``launch.hlo_stats.record_collectives``
is active), so one recorder sees the whole step.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.models.params import P, model_shard_dim

F32 = torch.float32

_CTX: Dict = {"mesh": None}

# callables ``hook(kind, result_bytes, group_size)``, one call per
# collective issued (the reference's HLO op names as kinds)
COLLECTIVE_HOOKS: List[Callable[[str, int, int], None]] = []


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


def scatter_mean_dim(x: torch.Tensor, dim: int, group, n: int
                     ) -> torch.Tensor:
    """This rank's ``1/n`` chunk along ``dim`` of the mean over the ``n``
    ranks of ``x``: reduce-scattered in f32 and cast back."""
    src = x.to(F32).movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=F32, device=src.device)
    _reduce_scatter_fn()(out, src, group=group)
    _note("reduce-scatter", out, group, n)
    out = out.div_(n).to(x.dtype)
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
    """Forward: the whole leaf from its shards (all-gather along ``dim``
    over ``group``); backward: the gradient's mean over the group,
    reduce-scattered back to this rank's shard."""

    @staticmethod
    def forward(ctx, shard, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return gather_dim(shard, dim, group, n)

    @staticmethod
    def backward(ctx, grad):
        return scatter_mean_dim(grad, ctx.dim, ctx.group, ctx.n), None, \
            None, None


def set_param_gather(mesh) -> None:
    """Install (or clear, with None) the gather context."""
    _CTX["mesh"] = mesh


@contextlib.contextmanager
def param_gather(mesh):
    """Install the gather context for ``mesh`` for the ``with`` body and
    restore the previous one after."""
    prev = _CTX["mesh"]
    set_param_gather(mesh)
    try:
        yield
    finally:
        set_param_gather(prev)


def _mesh_mp(mesh) -> int:
    return 1 if mesh is None else int(mesh.size(1))


def current_mesh():
    """The mesh of the installed gather context (None without one)."""
    return _CTX["mesh"]


def constrain_params(params, spec, mesh=None):
    """``params`` with each leaf that the plan shards gathered whole.

    ``spec`` is the spec tree of ``params`` (:class:`P` leaves with the
    canonical shapes and logical axes; a layer's slice takes the unstacked
    block spec).  ``mesh`` defaults to the installed context's (a block
    recomputed in the backward passes the one its forward saw).  Identity
    with no mesh or a "model" axis of 1."""
    mesh = _CTX["mesh"] if mesh is None else mesh
    mp = _mesh_mp(mesh)
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

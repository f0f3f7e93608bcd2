"""The :class:`PartitionPlan` mapping params (and the AdamW moments that
mirror them) to their layout on the (data, model) mesh, and the batch
checks — the port of ``repro.distributed.sharding``.

A layout here is a tuple of DTensor placements, one per mesh axis
("data", "model"): every param leaf is replicated over "data" and either
replicated or ``Shard(dim)`` over "model", with ``dim`` chosen by
``models.params.model_shard_dim``; batch-major tensors are
``Shard(axis)`` over "data".  The plan keeps the reference's API
(``param_specs``, ``param_shardings``, ``state_shardings``,
``bytes_report``) and adds what the reference gets from ``device_put`` and
``device_get``: :meth:`PartitionPlan.shard_state` slices a canonical
(unsharded) state to this rank's shards, :meth:`PartitionPlan.gather_state`
all-gathers the shards back over "model".  :class:`RulePlan` is the same
interface for a state laid out by the production rules
(``repro_torch.sharding``).  The reference's ``jit_*``
wrappers have no counterpart: the port runs eagerly, and its trainer and
engine issue the collectives themselves.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch import sharding as shlib
from repro_torch.distributed.mesh import (MODEL_AXIS, mesh_dp, mesh_mp,
                                          model_group, model_rank)
from repro_torch.models import params as params_lib
from repro_torch.sharding import gather_dim


def replicated(mesh) -> Tuple:
    """Replicated over both axes."""
    return (Replicate(), Replicate())


def batch_sharding(mesh, axis: int = 0) -> Tuple:
    """Dim ``axis`` sharded over "data" (batch-major layout)."""
    return (Shard(axis), Replicate())


# --------------------------------------------------------- tree paths

def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of nested dicts and NamedTuples: dict keys
    sorted, NamedTuple fields by name (the checkpoint's order)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in _flatten(v, prefix + (name,))]
    return [(prefix, tree)]


def _map(tree, fn, prefix: Tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(v, fn, prefix + (name,))
                            for name, v in zip(tree._fields, tree)])
    return fn(prefix, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


class PartitionPlan:
    """Per-leaf "model"-axis layout of a model's params, from its spec
    tree (``P`` leaves), and of any state leaf mirroring a param.

    Each leaf shards at most one dim over "model"; at ``mp = 1`` the whole
    plan is replicated.  Layouts are a runtime choice: checkpoints save
    the canonical layout (:meth:`gather_state`) and restore under any plan
    (:meth:`shard_state`, or ``checkpoint.load_checkpoint``'s
    ``slicer``)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec
        self.model_parallel = mesh_mp(mesh)
        self.data_parallel = mesh_dp(mesh)
        self._table = [(path, tuple(p.shape),
                        params_lib.model_shard_dim(p.shape, p.axes,
                                                   self.model_parallel))
                       for path, p in params_lib.leaves(spec)]

    # ---------------------------------------------------------- params
    def param_specs(self):
        """Tree (the param structure) of the sharded dim or None."""
        out: Dict = {}
        for path, _, dim in self._table:
            params_lib._set(out, path, dim)
        return out

    def param_shardings(self):
        """Tree (the param structure) of placement tuples."""
        out: Dict = {}
        for path, _, dim in self._table:
            params_lib._set(out, path, (Replicate(), Replicate())
                            if dim is None else (Replicate(), Shard(dim)))
        return out

    def _local_shape(self, shape: Tuple[int, ...], dim: Optional[int]
                     ) -> Tuple[int, ...]:
        if dim is None:
            return shape
        s = list(shape)
        s[dim] //= self.model_parallel
        return tuple(s)

    def _match(self, path: Tuple[str, ...], shape: Tuple[int, ...]
               ) -> Tuple[Optional[int], Optional[Tuple[int, ...]]]:
        """(sharded dim, canonical shape) of the state leaf at ``path``
        with ``shape`` (canonical, or already this rank's shard): those of
        the param whose path is the longest suffix of ``path`` with a
        matching shape; (None, None) for a leaf mirroring no param."""
        best, best_len = (None, None), -1
        for ppath, pshape, dim in self._table:
            n = len(ppath)
            if (n <= len(path) and path[len(path) - n:] == ppath
                    and shape in (pshape, self._local_shape(pshape, dim))
                    and n > best_len):
                best, best_len = (dim, pshape), n
        return best

    def state_shardings(self, state):
        """Tree (the structure of ``state``) of the sharded dim or None:
        a leaf whose path ends with a param's path and whose shape is that
        param's (the AdamW moments) inherits its dim; everything else (the
        step counter) is replicated."""
        return _map(state, lambda path, leaf: self._match(
            path, _shape(leaf))[0])

    # ---------------------------------------------------------- layouts
    def shard_leaf(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's shard of canonical ``t`` (a copy with a storage of
        its own: a view would keep the canonical storage alive), or ``t``
        itself when replicated."""
        if dim is None:
            return t
        n = t.shape[dim] // self.model_parallel
        return t.narrow(dim, model_rank(self.mesh) * n, n).clone(
            memory_format=torch.contiguous_format)

    def shard_state(self, state):
        """A canonical tree (params, or a whole RLState) sliced to this
        rank's shards; a leaf that already has its shard's shape is kept
        (so params a trainer on the same plan holds pass through)."""
        def one(path, leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            dim, pshape = self._match(path, _shape(leaf))
            if dim is None or _shape(leaf) != pshape:
                return leaf
            return self.shard_leaf(leaf, dim)
        return _map(state, one)

    def gather_state(self, state):
        """The canonical tree of a sharded one: each sharded leaf
        all-gathered over "model" (collective over the group)."""
        if self.model_parallel <= 1:
            return state
        flat_dims = dict(_flatten(self.state_shardings(state)))
        group, n = model_group(self.mesh), self.model_parallel
        return _map(state, lambda path, leaf: gather_dim(
            leaf, flat_dims[path], group, n)
            if flat_dims[path] is not None else leaf)

    def slicer(self, state):
        """``fn(key, array) -> array`` for ``checkpoint.load_checkpoint``:
        slices each canonical leaf read from disk (keys ``/``-joined, as
        the checkpoint names them) to this rank's shard of the leaf of
        ``state`` (a state laid out by this plan)."""
        flat = {"/".join(path): dim for path, dim in
                _flatten(self.state_shardings(state))}
        mp, r = self.model_parallel, model_rank(self.mesh)

        def cut(key, arr):
            dim = flat.get(key)
            if dim is None:
                return arr
            n = arr.shape[dim] // mp
            idx = [slice(None)] * arr.ndim
            idx[dim] = slice(r * n, (r + 1) * n)
            return arr[tuple(idx)]
        return cut

    def bytes_report(self, state) -> Dict[str, int]:
        """The canonical (unsharded) byte total against what one rank
        holds under this plan; equal when nothing is sharded.  ``state``
        may be canonical or laid out by the plan."""
        total = per_dev = sharded = 0
        for path, leaf in _flatten(state):
            if not isinstance(leaf, torch.Tensor):
                continue
            dim, pshape = self._match(path, _shape(leaf))
            nbytes = leaf.numel() * leaf.element_size()
            if dim is not None and _shape(leaf) != pshape:
                nbytes *= self.model_parallel      # a shard: scale it up
            total += nbytes
            per_dev += nbytes // (self.model_parallel if dim is not None
                                  else 1)
            sharded += dim is not None
        return {"total_bytes": int(total), "per_device_bytes": int(per_dev),
                "sharded_leaves": int(sharded)}


class RulePlan(PartitionPlan):
    """The layout of a model's params, and of any state leaf mirroring a
    param, under the production rules' storage table (``rules.stored`` of
    a ``repro_torch.sharding.Rules``): each leaf's (data dim, model dim),
    ``sharding.stored_layout``, a packed leaf's model dim cut component by
    component (``sharding.pack_cut``).  It keeps the ``PartitionPlan``'s
    interface, so a trainer laid out by the rules (``BaseTrainer(...,
    rules=True)``) checkpoints the canonical state, resumes under any
    layout and reports its bytes as under the plan.  A leaf's entry is
    its (data dim, model dim, component widths), or None where it is
    whole: a dim is None where its axis does not split the leaf, and the
    widths are those of a model dim cut component by component
    (``sharding.packed``; empty for a contiguous cut).  A plain tuple, a
    leaf of the trees ``state_shardings`` returns."""

    def __init__(self, mesh, spec, rules):
        self.mesh = mesh
        self.spec = spec
        self.rules = rules
        self.model_parallel = mesh_mp(mesh)
        self.data_parallel = mesh_dp(mesh)
        self._table = []
        for path, p in params_lib.leaves(spec):
            d, m = shlib.stored_layout(p.shape, p.axes, rules.stored, mesh)
            parts = (p.parts if shlib.packed(p.parts, p.shape, m,
                                             self.model_parallel) else ())
            self._table.append((path, tuple(p.shape),
                                None if (d, m) == (None, None)
                                else (d, m, parts)))

    def param_shardings(self):
        raise NotImplementedError(
            "a RulePlan leaf may shard two dims; read param_specs")

    def _local_shape(self, shape, dims):
        return (shape if dims is None
                else shlib.local_shape(shape, dims, self.mesh))

    def _cuts(self, dims):
        """(dim, ranks, this rank's index, component widths or ()) of each
        sharded dim."""
        return [(d, shlib.axis_size(self.mesh, name),
                 shlib._coord(self.mesh, name),
                 dims[2] if name == "model" else ())
                for d, name in zip(dims, ("data", "model")) if d is not None]

    def shard_leaf(self, t: torch.Tensor, dims) -> torch.Tensor:
        """This rank's shard of canonical ``t``: a copy with a storage of
        its own (a view would keep the canonical storage alive), or ``t``
        itself when whole."""
        if dims is None:
            return t
        for d, n, r, parts in self._cuts(dims):
            if parts:
                t = shlib.pack_cut(t, d, parts, n, r)
            else:
                k = t.shape[d] // n
                t = t.narrow(d, r * k, k)
        return t.clone(memory_format=torch.contiguous_format)

    def gather_state(self, state):
        """The canonical tree of a sharded one: each sharded dim
        all-gathered over its axis (collective over the mesh), a packed
        one put back in canonical order."""
        flat_dims = dict(_flatten(self.state_shardings(state)))

        def one(path, leaf):
            dims = flat_dims[path]
            if dims is None:
                return leaf
            for d, name in zip(dims, ("data", "model")):
                if d is not None:
                    n = shlib.axis_size(self.mesh, name)
                    leaf = gather_dim(leaf, d, self.mesh.get_group(name), n)
                    if name == "model" and dims[2]:
                        leaf = shlib.unpack(leaf, d, dims[2], n)
            return leaf
        return _map(state, one)

    def slicer(self, state):
        """``checkpoint.load_checkpoint``'s ``fn(key, array)``: each
        canonical leaf read from disk cut to this rank's shard."""
        flat = {"/".join(path): dims for path, dims in
                _flatten(self.state_shardings(state))}

        def cut(key, arr):
            dims = flat.get(key)
            if dims is None:
                return arr
            idx = [slice(None)] * arr.ndim
            for d, n, r, parts in self._cuts(dims):
                k = arr.shape[d] // n
                idx[d] = (shlib.pack_columns(parts, n, r) if parts
                          else slice(r * k, (r + 1) * k))
            return arr[tuple(idx)]
        return cut

    def bytes_report(self, state) -> Dict[str, int]:
        """The canonical byte total against what one rank holds; ``state``
        may be canonical or laid out by the plan."""
        total = per_dev = sharded = 0
        for path, leaf in _flatten(state):
            if not isinstance(leaf, torch.Tensor):
                continue
            dims, pshape = self._match(path, _shape(leaf))
            nbytes = leaf.numel() * leaf.element_size()
            split = 1 if dims is None else math.prod(
                n for _, n, _, _ in self._cuts(dims))
            if dims is not None and _shape(leaf) != pshape:
                nbytes *= split                  # a shard: scale it up
            total += nbytes
            per_dev += nbytes // split
            sharded += dims is not None
        return {"total_bytes": int(total), "per_device_bytes": int(per_dev),
                "sharded_leaves": int(sharded)}


def partition_plan(mesh, spec) -> Optional[PartitionPlan]:
    """The plan for ``mesh`` over a param ``spec`` tree (None without a
    mesh: the single-device path)."""
    if mesh is None:
        return None
    return PartitionPlan(mesh, spec)


# --------------------------------------------------------- validation

def check_batch_divisible(batch: int, mesh, microbatch: int = 0) -> None:
    """The reference's errors for a batch that the microbatch count or the
    data axis does not divide."""
    if microbatch and microbatch > 1 and batch % microbatch != 0:
        raise ValueError(
            f"batch size {batch} is not divisible by dist.microbatch="
            f"{microbatch}; pick a microbatch count that divides "
            f"num_prompts × group_size")
    per_chunk = batch // microbatch if microbatch and microbatch > 1 else batch
    dp = mesh_dp(mesh)
    if dp > 1 and per_chunk % dp != 0:
        raise ValueError(
            f"per-update batch {per_chunk} (batch {batch}"
            + (f" / microbatch {microbatch}" if microbatch > 1 else "")
            + f") is not divisible by the mesh data axis ({dp} devices); "
            "adjust num_prompts/group_size so every device gets equal work")


__all__ = ["MODEL_AXIS", "PartitionPlan", "partition_plan", "replicated",
           "batch_sharding", "check_batch_divisible"]

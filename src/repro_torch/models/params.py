"""Parameter specification trees and parameter trees.

A model is described by a nested dict whose leaves are :class:`P` — (shape,
logical axes, initializer), the same tree as ``repro.models.params``.  From
it come ``init`` (fresh tensors, drawn on the target device from an explicit
``torch.Generator``) and ``n_params``.  Parameters are nested dicts of
tensors under the same key paths as the JAX package's pytrees;
``from_numpy`` carries a JAX parameter tree (as numpy arrays) across, and
``state_dict`` flattens a tree to ``"."``-joined keys; ``axes_tree`` and
``shape_tree`` (meta tensors) are the dry run's stand-ins.
``model_shard_dim``
is the per-leaf decision of the ``PartitionPlan``: the dim a leaf shards
over the "model" mesh axis, from its logical axes alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | small
    scale: Optional[float] = None  # stddev override; default 1/sqrt(fan_in)
    # the widths of the components packed along the last dim (Mamba-2's
    # in_proj: z, x, B, C, dt; its conv: x, B, C), where a split over
    # "model" takes each component's slice (``sharding.packed``)
    parts: Tuple[int, ...] = ()

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def leaves(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in sorted-key order (the order of
    ``jax.tree.flatten`` over nested dicts)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _set(tree: Dict, path: Tuple[str, ...], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def stack(spec, n: int, axis_name: Optional[str] = "layers"):
    """Add a leading stacking dim (the per-layer loop slices it)."""
    if isinstance(spec, dict):
        return {k: stack(v, n, axis_name) for k, v in spec.items()}
    return P((n,) + spec.shape, (axis_name,) + spec.axes, spec.init,
             spec.scale, spec.parts)


# Logical axes eligible for "model"-axis sharding, in priority order (the
# reference's ``repro.models.params.MODEL_SHARDABLE``): for each leaf the
# FIRST axis listed here whose dim divides the model-parallel size is the
# one sharded.  Axes not listed (norm scales, head_dim, conv taps, the
# stacking "layers" dim) are never sharded.
MODEL_SHARDABLE: Tuple[str, ...] = (
    "experts", "experts_mdl",
    "heads", "kv_heads", "ssm_heads",
    "inner", "mlp", "moe_f",
    "vocab",
    "embed", "embed_r", "moe_in", "moe_out",
    "cond", "time", "latent",
)


def model_shard_dim(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
                    mp: int) -> Optional[int]:
    """The dim of a leaf of canonical ``shape`` and logical ``axes`` to
    shard over a "model" axis of size ``mp``, or None to replicate."""
    if mp <= 1:
        return None
    for name in MODEL_SHARDABLE:
        for i, ax in enumerate(axes):
            if ax == name and shape[i] >= mp and shape[i] % mp == 0:
                return i
    return None


def axes_tree(spec):
    """The spec tree with each leaf replaced by its logical axes."""
    if isinstance(spec, dict):
        return {k: axes_tree(v) for k, v in spec.items()}
    return spec.axes


def shape_tree(spec, dtype=torch.bfloat16):
    """The spec tree with each leaf replaced by an uninitialised tensor of
    its shape on ``device="meta"`` (no storage): the stand-in of the
    reference's ``ShapeDtypeStruct`` tree."""
    if isinstance(spec, dict):
        return {k: shape_tree(v, dtype) for k, v in spec.items()}
    return torch.empty(spec.shape, dtype=dtype, device="meta")


def n_params(spec) -> int:
    return sum(math.prod(p.shape) for _, p in leaves(spec))


def _std(p: P) -> float:
    if p.init == "normal":
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        return p.scale if p.scale is not None else 1.0 / math.sqrt(
            max(fan_in, 1))
    return p.scale if p.scale is not None else 0.02


def _init_leaf(p: P, gen: torch.Generator, dtype, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init not in ("normal", "small"):
        raise ValueError(f"unknown init {p.init}")
    std = _std(p)
    out = torch.empty(p.shape, dtype=dtype, device=device)
    # a stacked leaf is drawn one layer (or hybrid group) slice at a time,
    # so the f32 draw never holds more than one (at full width the stacked
    # w_gate alone would be a 5.7 GB f32 temporary)
    slices = [out[i] for i in range(p.shape[0])] if (
        p.axes and p.axes[0] in ("layers", "groups")) else [out]
    for sl in slices:
        draw = torch.randn(sl.shape, generator=gen, dtype=torch.float32,
                           device=device)
        sl.copy_(draw.mul_(std))
    return out


def init(spec, generator: torch.Generator, dtype=torch.bfloat16,
         device="cuda") -> Dict:
    """Fresh parameters for ``spec`` (leaves drawn in sorted key order from
    ``generator``, which must live on ``device``)."""
    out: Dict = {}
    for path, p in leaves(spec):
        _set(out, path, _init_leaf(p, generator, dtype, device))
    return out


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        # JAX bf16 arrays reach numpy as ml_dtypes.bfloat16: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_numpy(tree, device, dtype=None) -> Dict:
    """A nested dict of numpy arrays (a JAX parameter tree after
    ``jax.tree.map(np.asarray, params)``) -> the same tree of tensors on
    ``device``, cast to ``dtype`` when given, bit for bit otherwise."""
    out: Dict = {}
    for path, a in leaves(tree):
        t = _tensor_from_numpy(np.asarray(a)).to(device)
        _set(out, path, t if dtype is None else t.to(dtype))
    return out


def state_dict(tree) -> Dict[str, torch.Tensor]:
    """Flat ``{"backbone.blocks.attn.wq": tensor, ...}`` view of a tree."""
    return {".".join(path): t for path, t in leaves(tree)}

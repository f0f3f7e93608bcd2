"""Checkpoints: npz payload + msgpack/JSON manifest — the port of
``repro.checkpoint.io``, in the same on-disk format.

A tree (nested dicts, NamedTuples such as ``RLState``/``AdamWState``, lists)
is flattened to ``/``-joined key paths — dict keys sorted, NamedTuple fields
by name, list items by index — exactly as the reference names the leaves of
its pytrees (``params/backbone/blocks/attn/wq``, ``opt/step``,
``opt/mu/...``).  bf16 leaves are stored as a uint16 view and restored
through the manifest's dtype.  So a checkpoint crosses between the packages
in both directions, bit for bit.  Writes are atomic (temp file + rename),
the manifest first.

On disk the layout is always the canonical, unsharded one: a trainer on
a mesh saves ``canonical_state()`` (its shards all-gathered) from rank 0
alone, and restores under any layout by passing its plan's ``slicer``,
which cuts each leaf read from disk to the rank's shard before it reaches
the device.  So a checkpoint moves between layouts bit for bit.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

try:
    import msgpack
except ImportError:                      # pragma: no cover - env dependent
    msgpack = None                       # JSON manifests instead

_SEP = "/"


def _pack_manifest(manifest: dict) -> bytes:
    if msgpack is not None:
        return msgpack.packb(manifest)
    return json.dumps(manifest).encode()


def _unpack_manifest(raw: bytes) -> dict:
    # JSON manifests start with '{'; msgpack fixmaps never do
    if raw[:1] == b"{":
        return json.loads(raw.decode())
    if msgpack is None:
        raise RuntimeError("checkpoint manifest is msgpack-encoded but the "
                           "'msgpack' module is not installed")
    return msgpack.unpackb(raw)


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in _flatten(v, prefix + (name,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, prefix + (str(i),))]
    return [(_SEP.join(prefix), tree)]


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_unflatten(v, it) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, it) for v in tree)
    return next(it)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "keys": [], "dtypes": {}}
    for key, leaf in _flatten(tree):
        manifest["keys"].append(key)
        manifest["dtypes"][key] = _dtype_name(leaf)
        arrays[key] = _to_numpy(leaf)
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    # manifest lands before the npz: latest_step() keys on the .npz, so a
    # preemption between the two leaves at worst an orphan manifest
    tmp_m = path + ".tmp.manifest"
    with open(tmp_m, "wb") as f:
        f.write(_pack_manifest(manifest))
    os.replace(tmp_m, path + ".manifest")
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path + ".npz")
    return path + ".npz"


def _restore_leaf(arr: np.ndarray, dtype: str, like) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf shape {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
        t = t.to(device=like.device)
    return t


def load_checkpoint(ckpt_dir: str, step: int, like: Any,
                    slicer: Optional[Callable[[str, np.ndarray], np.ndarray]]
                    = None) -> Any:
    """Restore into the structure of ``like`` (shapes validated; each leaf
    on the device of its counterpart in ``like``).  ``slicer(key, array)``
    cuts each canonical leaf to the piece ``like`` holds (a
    ``PartitionPlan.slicer``)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(path + ".manifest", "rb") as f:
        manifest = _unpack_manifest(f.read())
    flat = _flatten(like)
    with np.load(path + ".npz") as z:
        missing = [key for key, _ in flat if key not in z.files]
        if missing:
            raise ValueError(
                f"checkpoint {path}.npz doesn't match the requested "
                f"structure: {len(missing)} missing key(s), e.g. "
                f"{missing[:3]}")
        cut = slicer or (lambda key, arr: arr)
        leaves = [_restore_leaf(cut(key, z[key]), manifest["dtypes"][key],
                                leaf)
                  for key, leaf in flat]
    return _unflatten(like, iter(leaves))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore_latest(ckpt_dir: str, like: Any, slicer=None
                   ) -> Tuple[Optional[int], Any]:
    """Restore the newest checkpoint into the structure of ``like``
    (``slicer`` as for :func:`load_checkpoint`); ``(None, like)`` when
    there is none."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None, like
    return step, load_checkpoint(ckpt_dir, step, like, slicer)

"""The (data, model) mesh of the port — ``repro.distributed.mesh`` over a
``torch.distributed`` process group.

One rank is one device.  ``resolve_axes`` resolves ``DistConfig``'s two
axis sizes against the group's world size (1 when no group is
initialised), where the reference reads ``jax.local_device_count()``: 0 on
an axis means "every rank the other axis leaves", and an axis larger than
what is there raises the reference's error with a launch hint.  A layout
must use every rank of the group (a rank outside the mesh would have
nothing to do), so ``train_mesh`` also refuses ``dp x mp`` below the world
size.

``train_mesh`` returns None at ``dp x mp = 1``, the exact single-device
path (no collective anywhere), and otherwise a
``torch.distributed.device_mesh.DeviceMesh`` of shape (dp, mp) named
("data", "model"): rank r sits at (r // mp, r % mp), so the ranks of one
data row hold the shards of one copy of the params.  ``build_mesh``
makes such a mesh for any (dp, mp) the group can hold, a one-rank group's
(1, 1) included: tests and the card's check drive the sharded path
through it.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import DistConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process() -> bool:
    """Rank 0 logs, writes the JSON log and writes checkpoints."""
    return rank() == 0


def _hint(want: int) -> str:
    return (f"launch with torchrun --nproc-per-node {want} (one process "
            f"per device; --device cpu runs them on gloo)")


def _resolve_axis(name: str, requested: int, available: int,
                  total: Optional[int] = None) -> int:
    """One axis: 0 -> all ``available`` ranks, else the configured count
    validated against what is there (the reference's ``_resolve_axis``,
    with a torchrun hint for its XLA_FLAGS one)."""
    if requested < 0:
        raise ValueError(f"dist.{name} must be >= 0, got {requested}")
    if requested == 0:
        return max(available, 1)
    if requested > available:
        want = total or requested
        raise ValueError(
            f"dist.{name}={requested} but only {available} device(s) are "
            f"available for this axis — {_hint(want)}")
    return requested


def resolve_axes(dist_cfg: DistConfig) -> Tuple[int, int]:
    """``(data_parallel, model_parallel)`` resolved against the world size,
    in the reference's order: an explicit ``model_parallel`` first, so
    ``data_parallel=0`` fills the remainder; with ``model_parallel=0`` the
    data axis resolves first and the model axis takes what is left."""
    n = world_size()
    dp_req = dist_cfg.data_parallel
    mp_req = dist_cfg.model_parallel
    if mp_req == 0:
        dp = _resolve_axis("data_parallel", dp_req, n)
        mp = n // dp
    else:
        mp = _resolve_axis("model_parallel", mp_req, n)
        dp = _resolve_axis("data_parallel", dp_req, n // mp,
                           total=dp_req * mp if dp_req > 0 else None)
    return dp, mp


def resolve_data_parallel(dist_cfg: DistConfig) -> int:
    return resolve_axes(dist_cfg)[0]


def resolve_model_parallel(dist_cfg: DistConfig) -> int:
    return resolve_axes(dist_cfg)[1]


def build_mesh(dp: int, mp: int, device_type: str):
    """The (dp, mp) ("data", "model") DeviceMesh over ranks 0..dp·mp-1 of
    the default group, which must hold exactly dp·mp ranks; works for a
    one-rank group's (1, 1).  Collective over the group."""
    from torch.distributed.device_mesh import DeviceMesh
    n = world_size()
    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialised torch.distributed process "
            "group (init_process_group)")
    if dp < 1 or mp < 1 or dp * mp != n:
        raise ValueError(
            f"a ({dp}, {mp}) mesh needs {dp * mp} ranks, the process group "
            f"has {n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, mp),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def train_mesh(dist_cfg: DistConfig, device_type: str = "cuda"):
    """None at ``dp x mp = 1`` (the exact single-device path), else the
    (dp, mp) mesh on ``device_type`` (``"cuda"``: NCCL, ``"cpu"``: gloo)."""
    dp, mp = resolve_axes(dist_cfg)
    if dp * mp <= 1:
        return None
    n = world_size()
    if dp * mp != n:
        raise ValueError(
            f"dist.data_parallel x dist.model_parallel = {dp} x {mp} uses "
            f"{dp * mp} of the process group's {n} ranks — {_hint(dp * mp)}"
            f" or set dist.data_parallel=0")
    return build_mesh(dp, mp, device_type)


def data_mesh(dist_cfg: DistConfig, device_type: str = "cuda"):
    """The reference's alias of :func:`train_mesh`."""
    return train_mesh(dist_cfg, device_type)


def mesh_dp(mesh) -> int:
    """Size of the "data" axis (1 for no mesh)."""
    return 1 if mesh is None else int(mesh.size(0))


def mesh_mp(mesh) -> int:
    """Size of the "model" axis (1 for no mesh)."""
    return 1 if mesh is None else int(mesh.size(1))


def data_rank(mesh) -> int:
    """This rank's coordinate on the "data" axis (0 for no mesh)."""
    return 0 if mesh is None else int(mesh.get_coordinate()[0])


def model_rank(mesh) -> int:
    """This rank's coordinate on the "model" axis (0 for no mesh)."""
    return 0 if mesh is None else int(mesh.get_coordinate()[1])


def data_group(mesh):
    return mesh.get_group(DATA_AXIS)


def model_group(mesh):
    return mesh.get_group(MODEL_AXIS)


def init_from_env(device: torch.device) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``): NCCL on
    ``cuda`` (each rank on ``cuda:LOCAL_RANK``), gloo on ``cpu``.  A
    no-op without ``WORLD_SIZE`` or with a group already initialised.
    Returns the device this rank runs on."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return device

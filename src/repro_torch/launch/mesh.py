"""Production mesh construction — the port of ``repro.launch.mesh``.

Target hardware: nodes of 8 NVIDIA H100 SXM5 80 GB cards ("NVIDIA H100
80GB HBM3", 700 W), one rank per card.  The production meshes keep the
reference's sizes: (data=16, model=16) = 256 ranks (32 nodes), and the
multi-pod mesh of 2 x 16 x 16 = 512 ranks.  The port's mesh is the 2-D
("data", "model") ``DeviceMesh`` of ``repro_torch.distributed``, with no
"pod" axis, so the multi-pod mesh folds the pods into "data" (32 x 16).
Defined as FUNCTIONS, so importing this module touches no device and no
process group.

Both meshes are built over the default process group, which must hold
exactly their ranks; where no such group exists (the dry run on one
host), :func:`fake_group` initialises torch's ``fake`` backend, whose
collectives return at once and move nothing.
"""
from __future__ import annotations

from typing import Tuple

import torch.distributed as dist

from repro_torch.distributed.mesh import build_mesh


def production_shape(multi_pod: bool = False) -> Tuple[int, int]:
    """(data, model) of the production mesh: the reference's (16, 16), or
    its (pod=2, 16, 16) with the pods folded into "data"."""
    return (2 * 16, 16) if multi_pod else (16, 16)


def fake_group(world_size: int, rank: int = 0) -> None:
    """Initialise the default process group on torch's ``fake`` backend
    with ``world_size`` ranks, this process being ``rank`` (global state:
    one per process)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    data, model = production_shape(multi_pod)
    return build_mesh(data, model, device_type)


def make_local_mesh(data: int = 1, model: int = 1,
                    device_type: str = "cuda"):
    """A (data, model) mesh over the default group's ranks (which must
    number data x model) — used by tests."""
    return build_mesh(data, model, device_type)


# H100 SXM5 80 GB constants (per card), from NVIDIA's datasheet: peaks, not
# measurements — used by the cost model's shares.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # B/s, HBM3
ICI_BW = 450e9                  # B/s per card per direction, NVLink 4
HBM_BYTES = 80e9                # B, device memory ("80 GB")
CARD = "NVIDIA H100 80GB HBM3, 700 W"

"""PerfConfig validation and the remat / dtype policy helpers (the port of
``repro.perf.policy``).

The remat policy keeps the reference's three values and their exactness
classes, but the port's losses back-propagate each timestep as soon as it
is computed (``core/trainers/grpo.py``), so one timestep's activations are
live at a time under the default policy already: the footprint the
reference buys with ``jax.checkpoint`` around its loss scan.  So
``"scan"`` runs the very program of ``"none"`` (bitwise, the reference's
contract for it), and so does ``"scan"`` with ``remat_offload``: with no
scan body there is no residual to offload (``perf.offload``).  Only
``"block"`` moves memory: it checkpoints each backbone layer
(``torch.utils.checkpoint``, non-reentrant) in the loss's velocity forward
and recomputes it in the backward.
"""
from __future__ import annotations

import torch

from repro_torch.config import PerfConfig

REMAT_MODES = ("none", "scan", "block")

POLICY_DTYPES = {
    "": None,                     # inherit the parameter dtype
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def validate(perf: PerfConfig) -> PerfConfig:
    """Fail construction-time on unknown knob values (a typo'd ``--set
    perf.remat=blocks`` must not silently train without remat)."""
    if perf.remat not in REMAT_MODES:
        raise ValueError(
            f"perf.remat must be one of {REMAT_MODES}, got {perf.remat!r}")
    if perf.policy_dtype not in POLICY_DTYPES:
        raise ValueError(
            f"perf.policy_dtype must be one of "
            f"{sorted(POLICY_DTYPES)}, got {perf.policy_dtype!r}")
    if perf.remat_offload and perf.remat != "scan":
        raise ValueError(
            "perf.remat_offload saves the scan body's named residuals to "
            "host memory and only composes with the scan-body checkpoint "
            f"— set perf.remat=scan (got remat={perf.remat!r})")
    return perf


def remat_policy(perf: PerfConfig):
    """The reference's scan-body checkpoint policy; always None here, as
    the port has no scan body to checkpoint (module docstring)."""
    return None


def resolve_policy_dtype(perf: PerfConfig):
    """The activation compute dtype for the velocity field, or ``None`` to
    inherit the parameter dtype (log-probs/optimizer stay f32 regardless)."""
    return POLICY_DTYPES[perf.policy_dtype]


def block_remat(remat: str) -> bool:
    """Whether the backbone's per-layer block remat should be threaded
    through ``FlowAdapter.velocity``."""
    return remat == "block"

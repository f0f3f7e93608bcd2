"""The kernel wrappers' launch counters, read and added to as one.

Each wrapper adds one to its ``.launches`` (and the attention's and
``ssd_scan``'s four to ``.variant_launches[variant]``, the attention's two
to ``.pair_launches[dims]``) where it launches its kernel.  A kernel
launched while a CUDA graph is being captured is only recorded, and runs
each time the graph is replayed: ``perf.fused.FusedStep`` takes a capture's
counts back out with :func:`add` (``times=-1``) and adds them again at
every replay, so the counters count the kernels that ran.

A process started with ``REPRO_KERNEL_COUNTS`` set to a directory writes
its counters there at exit, as ``<pid>.json``: how a caller reads the
launches of processes it starts (a sweep's combos), each from 0.
"""
from __future__ import annotations

import atexit
import json
import os
from typing import Dict

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd)
from repro_torch.kernels.grpo_loss import grpo_loss, grpo_loss_bwd
from repro_torch.kernels.sde_step import sde_step
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd

COUNTED = (sde_step, flash_attention, flash_attention_bwd, grpo_loss,
           grpo_loss_bwd, ssd_scan, ssd_scan_bwd)


def read() -> Dict[str, int]:
    """Every counter: ``name`` and, for a kernel with variants,
    ``name/variant``; with dim pairs, ``name@dims``."""
    out = {}
    for fn in COUNTED:
        out[fn.__name__] = fn.launches
        for v, n in getattr(fn, "variant_launches", {}).items():
            out[f"{fn.__name__}/{v}"] = n
        for pair, n in getattr(fn, "pair_launches", {}).items():
            out[f"{fn.__name__}@{pair}"] = n
    return out


def since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches counted since ``before`` (a :func:`read`)."""
    return {k: n - before[k] for k, n in read().items()}


def add(delta: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a :func:`since`) to the counters."""
    for fn in COUNTED:
        fn.launches += times * delta[fn.__name__]
        variants = getattr(fn, "variant_launches", {})
        for v in variants:
            variants[v] += times * delta[f"{fn.__name__}/{v}"]
        pairs = getattr(fn, "pair_launches", {})
        for pair in pairs:
            pairs[pair] += times * delta[f"{fn.__name__}@{pair}"]


def _write_at_exit(directory: str) -> None:
    with open(os.path.join(directory, f"{os.getpid()}.json"), "w") as f:
        json.dump(read(), f)


if os.environ.get("REPRO_KERNEL_COUNTS"):
    atexit.register(_write_at_exit, os.environ["REPRO_KERNEL_COUNTS"])

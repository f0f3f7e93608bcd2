"""Collective accounting of the port's step — the counterpart of
``repro.launch.hlo_stats``.

Torch has no HLO.  The reference parses the compiled (post-SPMD) module's
text and multiplies each scanned (``while``) body by its trip count; the
port's layers run as a Python loop, so each collective is recorded once,
as it is issued.  Every collective the port issues goes through
``repro_torch.sharding`` (``gather_dim`` and ``all_gather_rows``:
all-gather; ``scatter_mean_dim``: reduce-scatter; ``all_reduce_mean``,
``all_reduce_max`` and ``all_reduce_sum_``: all-reduce), which reports
each one's kind, result bytes and group size to the hooks that
:func:`record_collectives` installs.  Outside that context nothing is
recorded and nothing changes.

The result keeps the reference's schema, ``{kind: {"count",
"result_bytes", "moved_bytes"}, "_total": {...}}``, with ``moved_bytes``
the link bytes moved per device by the reference's textbook ring factors
(``_moved_bytes``).  :func:`op_histogram` counts the aten ops the step
dispatches (a ``TorchDispatchMode``, :func:`record_ops`), where the
reference counts HLO instructions.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, Iterable, List, Tuple

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import sharding as shlib

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

Record = Tuple[str, int, int]     # (kind, result bytes, group size)


def _moved_bytes(kind: str, result_bytes: int, g: int) -> float:
    """Per-device link traffic (ring algorithms)."""
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)          # operand = result × g
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(result_bytes)
    return 0.0


def collective_bytes(records: Iterable[Record]) -> Dict[str, Dict[str, float]]:
    """Per-kind count, result bytes and link bytes moved per device of the
    recorded collectives, and their ``_total``."""
    stats = {k: {"count": 0.0, "result_bytes": 0.0, "moved_bytes": 0.0}
             for k in COLLECTIVES}
    for kind, rb, g in records:
        stats[kind]["count"] += 1
        stats[kind]["result_bytes"] += rb
        stats[kind]["moved_bytes"] += _moved_bytes(kind, rb, g)
    out = {k: dict(v) for k, v in stats.items()}
    out["_total"] = {f: sum(v[f] for v in stats.values())
                     for f in ("count", "result_bytes", "moved_bytes")}
    return out


@contextlib.contextmanager
def record_collectives():
    """Record every collective issued in the ``with`` body: yields the
    list of :data:`Record` it fills."""
    records: List[Record] = []

    def hook(kind: str, nbytes: int, g: int) -> None:
        records.append((kind, nbytes, g))

    shlib.COLLECTIVE_HOOKS.append(hook)
    try:
        yield records
    finally:
        shlib.COLLECTIVE_HOOKS.remove(hook)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def record_ops():
    """Count the aten ops dispatched in the ``with`` body: yields the
    ``Counter`` (op name -> calls) it fills."""
    mode = _OpCounter()
    with mode:
        yield mode.counts


def op_histogram(counts: Dict[str, int], top: int = 30) -> Dict[str, float]:
    """The ``top`` most frequent ops of a :func:`record_ops` count."""
    return {k: float(v) for k, v in
            sorted(counts.items(), key=lambda kv: -kv[1])[:top]}

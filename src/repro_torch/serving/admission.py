"""Admission control, priority classes, and weighted-fair multi-tenant
scheduling for the serving engine — a copy of ``repro.serving.admission``
(pure Python; the port keeps its own so that it imports nothing of the
JAX package).

The engine's queue is the contention point between tenants under heavy
load, so its policy lives here, separate from the dispatch mechanics:

* **Priority classes** (:class:`PriorityClass`) — named tiers with a
  weighted-fair share (``weight``), a bounded queue depth (``max_depth``)
  and an optional default SLO (``slo_s``).  The defaults model the usual
  product split: ``interactive`` (small bounded queue, big share),
  ``standard``, and ``batch`` (deep queue, small share).
* **Admission control / backpressure** — :meth:`AdmissionController.admit`
  rejects a submit once its class is at ``max_depth`` by raising
  :class:`RetryAfter`, a *structured* error carrying a machine-readable
  payload (class, tenant, depth, limit, ``retry_after_s``) instead of
  queueing unboundedly.  ``retry_after_s`` is derived from the earliest
  dispatch deadline still queued in the class — the soonest a flush can
  free a slot — so clients back off a meaningful amount, deterministically
  under an injected clock.
* **Weighted-fair dequeue** — batches are filled by stride scheduling over
  the per-(class, tenant) FIFO queues: each queue holds a monotonically
  advancing ``pass`` value and the scheduler always serves the lowest one,
  advancing it by ``1 / (class_weight * tenant_weight)``.  Heavier queues
  therefore get proportionally more batch slots, and *every* backlogged
  queue's pass eventually becomes the minimum — no starvation, with a
  deterministic total order (ties break on class rank, then tenant name).
* **Deadline supremacy** — :meth:`take` serves queues holding a request
  whose dispatch deadline (the batching flush deadline or the request's
  SLO deadline, whichever is sooner) has expired *before* fairness
  applies: a deadline is a promise, fairness is a policy.

Everything here is pure host-side bookkeeping driven by the caller's
clock — no wall-clock reads, no randomness — which is what makes the
seeded fuzz harness in ``tests/test_torch_serving_engine.py``
deterministic.
"""
from __future__ import annotations

import math
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Tuple

if TYPE_CHECKING:                                    # pragma: no cover
    from repro_torch.serving.engine import Request


@dataclass(frozen=True)
class PriorityClass:
    """One priority tier: fair-share weight, bounded queue depth, and an
    optional default completion SLO applied to requests that don't carry
    their own."""

    name: str
    weight: int = 1
    max_depth: int = 64
    slo_s: Optional[float] = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("priority class needs a name")
        if self.weight < 1:
            raise ValueError(
                f"priority class {self.name!r}: weight must be >= 1, "
                f"got {self.weight}")
        if self.max_depth < 1:
            raise ValueError(
                f"priority class {self.name!r}: max_depth must be >= 1, "
                f"got {self.max_depth}")
        if self.slo_s is not None and self.slo_s <= 0:
            raise ValueError(
                f"priority class {self.name!r}: slo_s must be > 0, "
                f"got {self.slo_s}")


DEFAULT_CLASSES: Tuple[PriorityClass, ...] = (
    PriorityClass("interactive", weight=4, max_depth=32),
    PriorityClass("standard", weight=2, max_depth=64),
    PriorityClass("batch", weight=1, max_depth=256),
)


@dataclass(frozen=True)
class AdmissionConfig:
    """Queue policy for a :class:`~repro_torch.serving.ServingEngine`.

    ``tenant_weights`` is a tuple of (tenant, weight) pairs (tuple, not
    dict, so the config stays hashable/frozen); unlisted tenants weigh 1.
    """

    classes: Tuple[PriorityClass, ...] = DEFAULT_CLASSES
    tenant_weights: Tuple[Tuple[str, int], ...] = ()
    default_class: str = "standard"

    def __post_init__(self):
        names = [c.name for c in self.classes]
        if not names:
            raise ValueError("AdmissionConfig needs at least one class")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate priority class names: {names}")
        if self.default_class not in names:
            raise ValueError(
                f"default_class {self.default_class!r} is not one of "
                f"{names}")
        for tenant, w in self.tenant_weights:
            if w < 1:
                raise ValueError(
                    f"tenant {tenant!r}: weight must be >= 1, got {w}")

    def tenant_weight(self, tenant: str) -> int:
        return dict(self.tenant_weights).get(tenant, 1)


class RetryAfter(RuntimeError):
    """Structured admission rejection: the priority class's queue is at its
    bound.  Carries a JSON-ready payload so API layers can forward it
    verbatim (HTTP 429 + Retry-After semantics)."""

    def __init__(self, *, priority: str, tenant: str, depth: int,
                 limit: int, retry_after_s: float):
        self.priority = priority
        self.tenant = tenant
        self.depth = depth
        self.limit = limit
        self.retry_after_s = retry_after_s
        super().__init__(
            f"queue for priority class {priority!r} is full "
            f"({depth}/{limit} queued, tenant {tenant!r}) — retry in "
            f"{retry_after_s:.3f}s")

    def to_json(self) -> Dict[str, Any]:
        return {"error": "over_capacity", "priority": self.priority,
                "tenant": self.tenant, "depth": self.depth,
                "limit": self.limit,
                "retry_after_s": round(self.retry_after_s, 6)}


class AdmissionController:
    """Bounded, weighted-fair, deadline-aware request queues.

    One FIFO deque per (num_steps tier, class, tenant); stride-scheduling
    state (``_pass``) persists across dispatches so fair shares hold over
    the run, not per batch.  All methods take ``now`` from the caller —
    the controller never reads a clock.
    """

    def __init__(self, config: Optional[AdmissionConfig] = None):
        self.config = config or AdmissionConfig()
        self._classes: Dict[str, PriorityClass] = {
            c.name: c for c in self.config.classes}
        self._rank: Dict[str, int] = {
            c.name: i for i, c in enumerate(self.config.classes)}
        # per steps tier: (class, tenant) -> FIFO of Requests
        self._q: Dict[int, "OrderedDict[Tuple[str, str], deque]"] = {}
        self._pass: Dict[Tuple[str, str], float] = {}
        self._vtime = 0.0
        self.depths: Dict[str, int] = {c: 0 for c in self._classes}
        self.admitted: Dict[str, int] = {c: 0 for c in self._classes}
        self.rejected: Dict[str, int] = {c: 0 for c in self._classes}

    # ------------------------------------------------------------- classes
    def resolve_class(self, name: Optional[str]) -> PriorityClass:
        if name is None:
            name = self.config.default_class
        cls = self._classes.get(name)
        if cls is None:
            raise ValueError(
                f"unknown priority class {name!r} — configured classes: "
                f"{sorted(self._classes)}")
        return cls

    # ----------------------------------------------------------- admission
    def admit(self, req: "Request", now: float) -> None:
        """Enqueue ``req`` or raise :class:`RetryAfter` if its class is at
        its depth bound."""
        cls = self._classes[req.priority]
        depth = self.depths[req.priority]
        if depth >= cls.max_depth:
            self.rejected[req.priority] += 1
            raise RetryAfter(
                priority=req.priority, tenant=req.tenant, depth=depth,
                limit=cls.max_depth,
                retry_after_s=self._retry_after(req.priority, now))
        tier = self._q.setdefault(req.num_steps, OrderedDict())
        tier.setdefault((req.priority, req.tenant), deque()).append(req)
        self.depths[req.priority] += 1
        self.admitted[req.priority] += 1

    def _retry_after(self, priority: str, now: float) -> float:
        """Soonest a queue slot can free: the earliest dispatch deadline
        still queued in the class (a poll() then flushes it)."""
        soonest = math.inf
        for tier in self._q.values():
            for (cls, _), q in tier.items():
                if cls != priority:
                    continue
                for r in q:
                    soonest = min(soonest, r.deadline)
        if not math.isfinite(soonest):
            return 0.0
        return max(soonest - now, 0.0)

    # ------------------------------------------------------------ queries
    def tiers(self) -> List[int]:
        return [s for s, tier in self._q.items()
                if any(q for q in tier.values())]

    def ready(self, steps: int) -> int:
        tier = self._q.get(steps)
        if not tier:
            return 0
        return sum(len(q) for q in tier.values())

    def pending(self) -> int:
        return sum(self.depths.values())

    def has_expired(self, steps: int, now: float) -> bool:
        """Any queued request in the tier past its dispatch deadline?"""
        tier = self._q.get(steps)
        if not tier:
            return False
        return any(r.deadline <= now for q in tier.values() for r in q)

    def oldest_deadline(self, steps: int) -> float:
        tier = self._q.get(steps)
        if not tier:
            return math.inf
        return min((r.deadline for q in tier.values() for r in q),
                   default=math.inf)

    # ----------------------------------------------------------- dequeue
    def _queue_key(self, qk: Tuple[str, str]):
        """Deterministic stride order: lowest pass wins; ties break on
        class rank (config order = priority order), then tenant name."""
        return (self._pass.get(qk, self._vtime), self._rank[qk[0]], qk[1])

    def _charge(self, qk: Tuple[str, str]) -> None:
        cls, tenant = qk
        cur = max(self._pass.get(qk, self._vtime), self._vtime)
        stride = 1.0 / (self._classes[cls].weight
                        * self.config.tenant_weight(tenant))
        self._pass[qk] = cur + stride
        self._vtime = cur

    def _pop(self, tier, qk: Tuple[str, str]) -> "Request":
        req = tier[qk].popleft()
        self.depths[qk[0]] -= 1
        self._charge(qk)
        return req

    def take(self, steps: int, k: int, now: float) -> List["Request"]:
        """Dequeue up to ``k`` requests of the ``steps`` tier: queues
        holding an expired-deadline request flush first (front-of-queue
        FIFO order), then the remaining slots fill weighted-fair."""
        tier = self._q.get(steps)
        out: List["Request"] = []
        if not tier:
            return out
        # phase 1 — deadline supremacy: the queue whose earliest queued
        # deadline has expired is served before any fairness accounting
        while len(out) < k:
            best, best_key = None, None
            for qk, q in tier.items():
                d = min((r.deadline for r in q), default=math.inf)
                if d > now:
                    continue
                cand = (d, self._rank[qk[0]], qk[1])
                if best_key is None or cand < best_key:
                    best, best_key = qk, cand
            if best is None:
                break
            out.append(self._pop(tier, best))
        # phase 2 — weighted-fair fill from whatever is still queued
        while len(out) < k:
            nonempty = [qk for qk, q in tier.items() if q]
            if not nonempty:
                break
            out.append(self._pop(tier, min(nonempty, key=self._queue_key)))
        return out

    # -------------------------------------------------------------- stats
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready per-class view for the engine's stats/health."""
        return {
            c.name: {"depth": self.depths[c.name], "limit": c.max_depth,
                     "weight": c.weight, "slo_s": c.slo_s,
                     "admitted": self.admitted[c.name],
                     "rejected": self.rejected[c.name]}
            for c in self.config.classes}

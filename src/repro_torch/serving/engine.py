"""``ServingEngine`` — request-queue serving with bucketed continuous
batching, admission control, warmup and a cond-encoding cache: the port of
``repro.serving.engine`` on one device.

* **Requests**, not arrays, are the unit of work: ``submit()`` enqueues a
  (cond, seed, num_steps) request under a (tenant, priority class) and
  returns a handle; full buckets dispatch as in-flight slots allow, partial
  buckets flush when the oldest request crosses its dispatch deadline
  (``poll``) or on ``drain()``.
* **Admission control** (:mod:`repro_torch.serving.admission`): priority
  classes, weighted-fair dequeue across tenants, SLO deadlines, bounded
  queues that reject with :class:`RetryAfter`, and ``max_inflight`` bounding
  dispatched-but-unfetched batches (a batch whose handles are abandoned
  retires its slot on GC).
* **Shape buckets**: batches are padded up to a fixed tier ladder and
  ``num_steps`` is admitted only from the step-tier grid, so ``warmup()``
  runs every (bucket × step tier) shape once before traffic.  Padding is
  correct, not just safe: each request's latent is drawn from a
  ``torch.Generator`` seeded with its own integer seed
  (:func:`repro_torch.core.rollout.rollout_keyed`), whatever batch it
  lands in.
* **Cond-encoding cache**: repeat prompts skip the ConditionProvider (an
  LRU keyed by prompt string).

* **Sharded inference** (``dist`` / ``mesh``): on a (data, model) mesh
  the bucket grid is dp-aligned and each data rank runs its slice of a
  bucket (``repro_torch.distributed.make_rollout_keyed_sharded``); the
  latents are all-gathered, so every rank holds the bucket's.  Each
  request's latent is the one-device engine's (its draws are its own
  seed's).  On a "model" axis the params are held as this rank's shards
  of the ``PartitionPlan`` and each layer gathers its slice.  Every rank
  submits the same requests in the same order.

The port runs eagerly, so the reference's jit compile accounting
(``compiles``, ``cold_dispatches``, ``compiled_shapes``) has no counterpart
and is not in ``stats``.  The trainer-facing ``rollout`` comes with a
later slice.
"""
from __future__ import annotations

import itertools
import math
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import distributed
from repro_torch.core.rollout import fold_seed, request_seeds
from repro_torch.serving.admission import (AdmissionConfig, AdmissionController,
                                           RetryAfter)
from repro_torch.serving.buckets import BucketGrid, StepGrid

# distinct auto-seed stream per engine instance: the auto seed of request
# rid is fold_seed(fold_seed(BASE, engine_seq), rid)
_AUTO_SEED_BASE = 0x466C6F77            # "Flow"
_ENGINE_SEQ = itertools.count()


class _BatchResult:
    """Shared result holder for one dispatched bucket: keeps the device
    tensor (the launches stay queued on the stream, so the next batch's
    host work overlaps this one's compute) and pays the device->host copy
    once per BATCH on first access.  The batch's in-flight slot retires on
    materialization OR on GC, whichever comes first."""

    __slots__ = ("_dev", "_np", "_retire", "__weakref__")

    def __init__(self, x0_dev: torch.Tensor,
                 on_materialize: Optional[Callable[[], None]] = None):
        self._dev = x0_dev
        self._np: Optional[np.ndarray] = None
        if on_materialize is None:
            self._retire = None
        else:
            cell = [on_materialize]

            def retire_once():
                if cell:
                    cell.pop()()

            self._retire = retire_once
            # the callback closes over the cell, never over self
            weakref.finalize(self, retire_once)

    def row(self, i: int) -> np.ndarray:
        if self._np is None:
            self._np = self._dev.cpu().numpy()
            self._dev = None
            if self._retire is not None:
                self._retire()
        return self._np[i]


class Request:
    """One enqueued sampling request; doubles as its result handle.  cond
    lives on the host (numpy); ``seed`` is the request's integer seed."""

    __slots__ = ("rid", "cond", "seed", "num_steps", "arrival", "tenant",
                 "priority", "deadline", "slo_deadline", "_result")

    def __init__(self, rid: int, cond: np.ndarray, seed: int,
                 num_steps: int, arrival: float, *,
                 tenant: str = "default", priority: str = "standard",
                 deadline: float = math.inf,
                 slo_deadline: float = math.inf):
        self.rid = rid
        self.cond = cond
        self.seed = seed
        self.num_steps = num_steps
        self.arrival = arrival
        self.tenant = tenant
        self.priority = priority
        self.deadline = deadline
        self.slo_deadline = slo_deadline
        self._result: Optional[tuple] = None        # (_BatchResult, row)

    @property
    def done(self) -> bool:
        return self._result is not None

    def result(self) -> np.ndarray:
        if self._result is None:
            raise RuntimeError(
                f"request {self.rid} has not been served yet — call "
                "engine.poll() past its deadline or engine.drain()")
        holder, row = self._result
        return holder.row(row)


class CondCache:
    """LRU prompt -> condition-embedding cache (host numpy rows)."""

    def __init__(self, max_entries: int = 1024):
        self.max_entries = max_entries
        self._store: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, prompt: str) -> Optional[np.ndarray]:
        cond = self._store.get(prompt)
        if cond is None:
            self.misses += 1
            return None
        self._store.move_to_end(prompt)
        self.hits += 1
        return cond

    def put(self, prompt: str, cond: np.ndarray) -> None:
        self._store[prompt] = cond
        self._store.move_to_end(prompt)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    def __len__(self) -> int:
        return len(self._store)


class ServingEngine:
    """Bucketed continuous-batching inference over a FlowAdapter, on
    ``device`` (the device the params lie on).

    ``step_tiers`` is the admitted ``num_steps`` ladder (always including
    ``num_steps``); ``admission`` configures priority classes / tenant
    weights / queue bounds; ``max_inflight`` bounds dispatched-but-unfetched
    batches.  ``dist``: a ``DistConfig``, resolved to the engine's mesh
    (``mesh=`` injects one instead; ``plan`` a ``PartitionPlan``, built
    from the adapter's spec when the mesh has a "model" axis)."""

    def __init__(self, adapter, scheduler, params, *, num_steps: int,
                 device, max_batch: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 step_tiers: Optional[Sequence[int]] = None,
                 deadline_s: float = 0.005,
                 admission: Optional[AdmissionConfig] = None,
                 max_inflight: int = 4, dist=None, mesh=None, plan=None,
                 provider=None, cond_len: int = 16,
                 cond_cache_entries: int = 1024,
                 clock: Callable[[], float] = time.monotonic):
        if max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {max_inflight}")
        if params is None:
            raise ValueError("the serving engine needs params")
        self.adapter = adapter
        self.scheduler = scheduler
        self.device = torch.device(device)
        if mesh is None and dist is not None:
            mesh = distributed.train_mesh(dist, self.device.type)
        self.mesh = mesh
        if plan is None and distributed.mesh_mp(mesh) > 1:
            plan = distributed.partition_plan(mesh, adapter.spec())
        self.plan = plan
        self.params = params if plan is None else plan.shard_state(params)
        self._fns: Dict[int, Callable] = {}
        self.steps = StepGrid(step_tiers, default=num_steps)
        self.num_steps = num_steps
        self.deadline_s = deadline_s
        self.max_inflight = max_inflight
        self.provider = provider
        self.cond_len = cond_len
        self.clock = clock
        self.grid = BucketGrid(buckets, max_batch=max_batch,
                               dp=distributed.mesh_dp(mesh))
        self.admission = AdmissionController(admission)
        self.cond_cache = CondCache(cond_cache_entries)
        self._base_seed = fold_seed(_AUTO_SEED_BASE, next(_ENGINE_SEQ))
        self._warmed: set = set()          # (bucket, num_steps) run in warmup
        self._inflight = 0
        self._next_rid = 0
        self.counters: Dict[str, Any] = {
            "requests": 0, "dispatches": {}, "padded_lanes": 0,
            "warmup_s": 0.0, "served_by_class": {}, "served_by_tenant": {},
            "slo_misses": {},
        }

    # -------------------------------------------------------------- encoding
    def encode(self, prompts: Sequence[str]) -> np.ndarray:
        """(N, Lc, D) condition embeddings (host-side), LRU-cached per
        prompt; misses are encoded in ONE ConditionProvider batch."""
        if self.provider is None:
            raise ValueError(
                "this engine has no ConditionProvider — submit cond "
                "embeddings directly or construct with provider=...")
        out: Dict[int, np.ndarray] = {}
        miss_rows: Dict[str, List[int]] = {}     # unique prompt -> indices
        for i, p in enumerate(prompts):
            if p in miss_rows:                   # in-batch duplicate: a hit
                miss_rows[p].append(i)
                self.cond_cache.hits += 1
                continue
            cached = self.cond_cache.get(p)
            if cached is None:
                miss_rows[p] = [i]
            else:
                out[i] = cached
        if miss_rows:
            fresh = self.provider.get(list(miss_rows))["cond"]
            fresh = fresh.to(torch.float32).cpu().numpy()
            for j, (p, rows) in enumerate(miss_rows.items()):
                # .copy(): a cached row must not pin the whole batch array
                self.cond_cache.put(p, fresh[j].copy())
                for i in rows:
                    out[i] = fresh[j]
        return np.stack([out[i] for i in range(len(prompts))])

    # ----------------------------------------------------------------- queue
    def submit(self, cond=None, *, prompt: Optional[str] = None,
               seed: Optional[int] = None, num_steps: Optional[int] = None,
               tenant: str = "default", priority: Optional[str] = None,
               slo_s: Optional[float] = None) -> Request:
        """Enqueue one request; returns its handle.  The request's latent is
        determined by (cond, seed, num_steps) alone.  Without ``seed`` the
        engine assigns one from its own stream.

        Raises :class:`RetryAfter` when the priority class's queue is at its
        depth bound, and ``ValueError`` for an off-grid ``num_steps`` or a
        cond shape other than (cond_len, cond_dim)."""
        if (cond is None) == (prompt is None):
            raise ValueError("submit exactly one of cond= or prompt=")
        if cond is None:
            cond = self.encode([prompt])[0]
        cond = np.asarray(cond, dtype=np.float32)
        expect = (self.cond_len, self.adapter.cond_dim)
        if cond.shape != expect:
            raise ValueError(
                f"request cond must be (Lc, cond_dim) = {expect} — the "
                f"shape the engine is warmed for — got {cond.shape}")
        steps = self._resolve_steps(num_steps)
        cls = self.admission.resolve_class(priority)
        if seed is None:
            seed = fold_seed(self._base_seed, self._next_rid)
        if slo_s is not None and slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {slo_s}")
        slo = slo_s if slo_s is not None else cls.slo_s
        now = self.clock()
        slo_deadline = now + slo if slo is not None else math.inf
        req = Request(self._next_rid, cond, int(seed), steps, now,
                      tenant=tenant, priority=cls.name,
                      deadline=min(now + self.deadline_s, slo_deadline),
                      slo_deadline=slo_deadline)
        self.admission.admit(req, now)     # may raise RetryAfter
        self._next_rid += 1
        self.counters["requests"] += 1
        self._pump(now)
        return req

    def _pump(self, now: float) -> int:
        """Continuous batching under backpressure: dispatch full buckets
        while in-flight slots allow.  Returns requests dispatched."""
        n = 0
        while self._inflight < self.max_inflight:
            tier = next((s for s in self.admission.tiers()
                         if self.admission.ready(s) >= self.grid.capacity),
                        None)
            if tier is None:
                break
            batch = self.admission.take(tier, self.grid.capacity, now)
            self._dispatch(batch)
            n += len(batch)
        return n

    def poll(self) -> int:
        """Flush queues holding a request past its dispatch deadline — at
        most ``2 * max_inflight`` deadline dispatches per call — then
        dispatch any full buckets.  Returns requests dispatched."""
        now = self.clock()
        n = 0
        flushes, flush_cap = 0, 2 * self.max_inflight
        for steps in list(self.admission.tiers()):
            while (flushes < flush_cap
                   and self.admission.has_expired(steps, now)):
                batch = self.admission.take(steps, self.grid.capacity, now)
                self._dispatch(batch)
                flushes += 1
                n += len(batch)
        n += self._pump(now)
        return n

    def drain(self) -> int:
        """Dispatch everything still queued, deadline or not."""
        now = self.clock()
        n = 0
        for steps in list(self.admission.tiers()):
            while self.admission.ready(steps):
                batch = self.admission.take(steps, self.grid.capacity, now)
                self._dispatch(batch)
                n += len(batch)
        return n

    def pending(self) -> int:
        return self.admission.pending()

    # ------------------------------------------------------------- execution
    def _resolve_steps(self, num_steps: Optional[int]) -> int:
        return self.steps.resolve(num_steps)

    @torch.no_grad()
    def _execute(self, cond: np.ndarray, seeds: Sequence[int],
                 num_steps: int, params=None) -> torch.Tensor:
        """Run one bucket-shaped batch -> (bucket, Lt, ld) f32 latents on
        the engine's device (queued on the stream, not synchronised)."""
        fn = self._fns.get(num_steps)
        if fn is None:
            fn = self._fns[num_steps] = distributed.make_rollout_keyed_sharded(
                self.adapter, self.scheduler, num_steps, self.mesh,
                x0_only=True, plan=self.plan)
        cond_t = torch.from_numpy(cond).to(self.device)
        return fn(self.params if params is None else params, cond_t, seeds)

    def _pad(self, arr: np.ndarray, bucket: int) -> np.ndarray:
        pad = bucket - arr.shape[0]
        if not pad:
            return arr
        return np.concatenate(
            [arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])

    def _retire_inflight(self) -> None:
        self._inflight -= 1
        # a freed slot may unblock a queued full bucket right away
        self._pump(self.clock())

    def _dispatch(self, batch: List[Request]) -> None:
        steps = batch[0].num_steps
        bucket = self.grid.pick(len(batch))
        d = self.counters["dispatches"]
        d[(bucket, steps)] = d.get((bucket, steps), 0) + 1
        self.counters["padded_lanes"] += bucket - len(batch)
        now = self.clock()
        served_c = self.counters["served_by_class"]
        served_t = self.counters["served_by_tenant"]
        misses = self.counters["slo_misses"]
        for r in batch:
            served_c[r.priority] = served_c.get(r.priority, 0) + 1
            served_t[r.tenant] = served_t.get(r.tenant, 0) + 1
            if now > r.slo_deadline:
                misses[r.priority] = misses.get(r.priority, 0) + 1
        cond = self._pad(np.stack([r.cond for r in batch]), bucket)
        # padded lanes take seed 0: their draws never touch a real lane
        seeds = [r.seed for r in batch] + [0] * (bucket - len(batch))
        self._inflight += 1
        holder = _BatchResult(self._execute(cond, seeds, steps),
                              on_materialize=self._retire_inflight)
        for i, r in enumerate(batch):
            r._result = (holder, i)

    # ----------------------------------------------------------- conveniences
    def serve(self, requests: Union[Sequence[str], np.ndarray],
              seed: int = 0, num_steps: Optional[int] = None, *,
              tenant: str = "default",
              priority: Optional[str] = None) -> torch.Tensor:
        """Synchronous batch serve: prompts (via the cond cache) or a
        (N, Lc, D) cond array -> (N, Lt, ld) f32 latents on the host.
        Request i's seed is ``fold_seed(seed, i)``, so per-request results
        do not depend on N, the bucket layout or max_batch.  On
        :class:`RetryAfter` it flushes the backlog and fetches finished
        batches (retiring their slots) before resubmitting."""
        if len(requests) == 0:
            fc = self.adapter.flow_cfg
            return torch.zeros((0, fc.latent_tokens, fc.latent_dim))
        if isinstance(requests[0], str):
            cond = self.encode(list(requests))
        else:
            cond = np.asarray(requests, dtype=np.float32)
        seeds = request_seeds(seed, cond.shape[0])
        handles: List[Request] = []
        for i in range(cond.shape[0]):
            while True:
                try:
                    handles.append(self.submit(
                        cond=cond[i], seed=seeds[i], num_steps=num_steps,
                        tenant=tenant, priority=priority))
                    break
                except RetryAfter:
                    self.drain()
                    for h in handles:
                        if h.done:
                            h.result()
        self.drain()
        return torch.from_numpy(np.stack([h.result() for h in handles]))

    # ---------------------------------------------------------------- warmup
    def warmup(self, num_steps_tiers: Optional[Sequence[int]] = None,
               params=None) -> Dict[str, float]:
        """Run every (bucket × step tier) shape once on zero conditions, so
        that kernel builds, library handles and the allocator's pools are in
        place before traffic.  Returns per-shape seconds (synchronised);
        the total also lands in ``counters['warmup_s']``."""
        tiers = sorted(set(num_steps_tiers or self.steps.sizes))
        report: Dict[str, float] = {}
        for steps in tiers:
            for bucket in self.grid.sizes:
                cond = np.zeros((bucket, self.cond_len,
                                 self.adapter.cond_dim), np.float32)
                t0 = time.perf_counter()
                x0 = self._execute(cond, [0] * bucket, steps, params)
                x0.cpu()
                report[f"b{bucket}/s{steps}"] = time.perf_counter() - t0
                self._warmed.add((bucket, steps))
        self.counters["warmup_s"] += sum(report.values())
        return report

    # ----------------------------------------------------------------- stats
    @property
    def stats(self) -> Dict[str, Any]:
        """JSON-serializable stats/health snapshot (tuple keys are
        stringified as ``"b<bucket>/s<steps>"``)."""
        c = self.counters
        return {
            "requests": c["requests"],
            "pending": self.pending(),
            "inflight": self._inflight,
            "max_inflight": self.max_inflight,
            "dispatches": {f"b{b}/s{s}": n
                           for (b, s), n in sorted(c["dispatches"].items())},
            "padded_lanes": c["padded_lanes"],
            "warmed_shapes": [f"b{b}/s{s}" for b, s in sorted(self._warmed)],
            "warmup_s": c["warmup_s"],
            "priorities": self.admission.snapshot(),
            "served_by_class": dict(c["served_by_class"]),
            "served_by_tenant": dict(c["served_by_tenant"]),
            "slo_misses": dict(c["slo_misses"]),
            "cond_cache": {"hits": self.cond_cache.hits,
                           "misses": self.cond_cache.misses,
                           "entries": len(self.cond_cache)},
            "buckets": list(self.grid.sizes),
            "step_tiers": list(self.steps.sizes),
            "device": str(self.device),
            "data_parallel": distributed.mesh_dp(self.mesh),
            "model_parallel": distributed.mesh_mp(self.mesh),
        }

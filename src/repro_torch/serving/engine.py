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

* **Trainer rollouts** (``for_trainer`` / ``rollout``, what
  ``BaseTrainer.attach_engine`` opts into): a batch of B rows runs in
  capacity-sized chunks, each padded on the device to its smallest bucket
  and run through the same executor as the queue path, and the full
  Trajectory of exactly B rows comes back; row i draws from
  ``fold_seed(seed, i)``, so its trajectory does not depend on the
  chunking.  Such an engine may hold no params: the trainer passes its own
  to every call.

* **Compiled executables** (the reference's compile cache): on a CUDA
  device each (bucket, steps, x0_only) shape runs as one captured CUDA
  graph of the whole rollout (``perf.graphs.GraphCache``), keyed also by
  what the eager body specialises on (the SDE-mask pattern, which draws
  the caller injected, the condition's shape and dtype).  ``warmup()``
  runs each (bucket × step tier) shape once eagerly and captures it, and
  every later dispatch of the shape is one ``replay()``; a dispatch of an
  uncaptured shape captures it on the hot path (the reference's cold
  compile).  Each request's draws are made eagerly from its own seed
  (``request_draws``) and copied into the graph's static inputs, so its
  latent stays a function of (cond, seed, num_steps).  The graphs read the
  params by storage: in-place updates (AdamW's) reach every replay, and a
  call whose param storages differ from the captured ones recaptures.
  There is no switch and no fallback: a capture that fails raises.  On the
  CPU the body runs eagerly.  ``stats`` counts ``compiles`` and
  ``cold_dispatches`` and lists ``compiled_shapes`` with the reference's
  semantics on either device; the graphs' own figures (captures, replays,
  launches per replay, the pool's bytes) are in :meth:`graph_report`.
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
from repro_torch.core.rollout import (Trajectory, fold_seed, request_draws,
                                      request_seeds)
from repro_torch.models.params import leaves
from repro_torch.perf.graphs import GraphCache
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

    ``params`` may be None for the trainer-rollout path (params are then
    passed per :meth:`rollout` call); the queue path (:meth:`submit` /
    :meth:`serve`) and :meth:`warmup` need them.

    ``step_tiers`` is the admitted ``num_steps`` ladder (always including
    ``num_steps``); ``admission`` configures priority classes / tenant
    weights / queue bounds; ``max_inflight`` bounds dispatched-but-unfetched
    batches.  ``dist``: a ``DistConfig``, resolved to the engine's mesh
    (``mesh=`` injects one instead; ``plan`` a ``PartitionPlan``, built
    from the adapter's spec when the mesh has a "model" axis)."""

    def __init__(self, adapter, scheduler, params=None, *, num_steps: int,
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
        self.adapter = adapter
        self.scheduler = scheduler
        self.device = torch.device(device)
        if mesh is None and dist is not None:
            mesh = distributed.train_mesh(dist, self.device.type)
        self.mesh = mesh
        if getattr(plan, "rules", None) is not None:
            raise ValueError("the engine's rollouts run the PartitionPlan's "
                             "layout, not the production rules' (a trainer "
                             "built with rules=True)")
        if plan is None and distributed.mesh_mp(mesh) > 1:
            plan = distributed.partition_plan(mesh, adapter.spec())
        self.plan = plan
        self.params = (params if plan is None or params is None
                       else plan.shard_state(params))
        self._fns: Dict[tuple, Callable] = {}
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
        self._traced: set = set()          # (bucket, steps, x0_only) compiled
        self._warmed: set = set()          # the shapes warmup ran
        # every graph of the engine on one pool: safe only because the
        # replays run one at a time on the caller's stream and each one's
        # outputs are cloned before the next is queued (``_BatchResult``
        # holds the clone while later batches run)
        self._graphs = (GraphCache(self.device)
                        if self.device.type == "cuda" else None)
        self._inflight = 0
        self._next_rid = 0
        self.counters: Dict[str, Any] = {
            "requests": 0, "dispatches": {}, "padded_lanes": 0,
            "compiles": 0, "cold_dispatches": 0,
            "warmup_s": 0.0, "served_by_class": {}, "served_by_tenant": {},
            "slo_misses": {},
        }

    # ---------------------------------------------------------- construction
    @classmethod
    def for_trainer(cls, trainer, **kw) -> "ServingEngine":
        """Engine sharing a trainer's adapter, scheduler, num_steps, device
        and mesh (and by default its ``PartitionPlan``) — the object to pass
        to ``trainer.attach_engine``.  ``max_batch`` caps the rollout chunk
        size (a memory bound); larger batches run in capacity-sized
        chunks."""
        kw.setdefault("plan", getattr(trainer, "plan", None))
        return cls(trainer.adapter, trainer.scheduler,
                   num_steps=trainer.flow.num_steps, device=trainer.device,
                   mesh=trainer.mesh, **kw)

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

    def _account(self, bucket: int, num_steps: int, n_real: int,
                 x0_only: bool) -> None:
        """The dispatch bookkeeping of one bucket, for the queue and the
        rollout paths alike: the compile cache's and the dispatch and
        padding counters.  Shapes are keyed (bucket, steps, x0_only), as the
        two executor variants compile separately: warmup covers the queue
        (x0_only) variant, so a trainer-path rollout at the same (bucket,
        steps) is still a cold compile."""
        self._note_trace((bucket, num_steps, x0_only))
        d = self.counters["dispatches"]
        d[(bucket, num_steps)] = d.get((bucket, num_steps), 0) + 1
        self.counters["padded_lanes"] += bucket - n_real

    def _note_trace(self, shape, during_warmup: bool = False) -> None:
        if shape in self._traced:
            return
        self._traced.add(shape)
        self.counters["compiles"] += 1
        if not during_warmup and shape not in self._warmed:
            self.counters["cold_dispatches"] += 1

    def _fn(self, num_steps: int, x0_only: bool = False) -> Callable:
        fn = self._fns.get((num_steps, x0_only))
        if fn is None:
            fn = self._fns[(num_steps, x0_only)] = \
                distributed.make_rollout_keyed_sharded(
                    self.adapter, self.scheduler, num_steps, self.mesh,
                    x0_only=x0_only, plan=self.plan)
        return fn

    @torch.no_grad()
    def _run(self, params, cond: torch.Tensor, seeds: Sequence[int],
             num_steps: int, x0_only: bool, sde_mask=None, **draws):
        """One bucket through the executor of (num_steps, x0_only): the
        final latents with ``x0_only``, else the Trajectory.  On a CUDA
        device the key's graph is replayed, or captured first; on the CPU
        the executor runs eagerly.  ``draws`` (``x_init`` / ``eps``, the
        bucket's) replace the seeded draws."""
        fn = self._fn(num_steps, x0_only)
        draws = {k: v for k, v in draws.items() if v is not None}
        if self._graphs is None:
            return fn(params, cond, seeds, sde_mask, **draws)
        mask = (tuple([True] * num_steps) if sde_mask is None
                else tuple(bool(m) for m in sde_mask))
        key = (tuple(cond.shape), cond.dtype, num_steps, x0_only, mask,
               tuple(sorted(draws)))
        inputs = {"cond": cond, **self._draws(seeds, num_steps, draws)}
        storages = tuple(t.data_ptr() for _, t in leaves(params))
        entry = self._graphs.get(key)
        if entry is not None and entry.meta == storages:
            return self._graphs.replay(key, inputs)
        label = (f"b{cond.shape[0]}/s{num_steps}"
                 + ("" if x0_only else "/traj")
                 + ("" if all(mask) else
                    "/sde" + "".join("1" if m else "0" for m in mask)))
        static = self._graphs.static_inputs(inputs)
        return self._graphs.capture(
            key, static, fn, params, static["cond"], seeds, list(mask),
            x_init=static["x_init"], eps=static["eps"], label=label,
            meta=storages)

    def _draws(self, seeds: Sequence[int], num_steps: int,
               given: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The bucket's ``x_init`` (B, Lt, ld) and ``eps`` (T, B, Lt, ld)
        in f32 on the device: the caller's where given, else each row's
        own from its seed (``request_draws``, as ``rollout_keyed`` draws
        them), made eagerly outside the graph."""
        out = {k: v.to(device=self.device, dtype=torch.float32)
               for k, v in given.items()}
        if len(out) < 2:
            rows = [request_draws(self.adapter, s, num_steps, self.device)
                    for s in seeds]
            out.setdefault("x_init", torch.stack([r[0] for r in rows]))
            out.setdefault("eps", torch.stack([r[1] for r in rows], dim=1))
        return out

    def _execute(self, cond: np.ndarray, seeds: Sequence[int],
                 num_steps: int, params=None) -> torch.Tensor:
        """Run one bucket-shaped batch -> (bucket, Lt, ld) f32 latents on
        the engine's device (queued on the stream, not synchronised;
        accounting is the caller's)."""
        cond_t = torch.from_numpy(cond).to(self.device)
        return self._run(self.params if params is None else params, cond_t,
                         seeds, num_steps, True)

    @staticmethod
    def _pad(arr, bucket: int, dim: int = 0):
        """``arr`` (numpy or a tensor, padded where it lies) with zero rows
        up to ``bucket`` along ``dim``."""
        pad = bucket - arr.shape[dim]
        if not pad:
            return arr
        shape = list(arr.shape)
        shape[dim] = pad
        if isinstance(arr, np.ndarray):
            return np.concatenate([arr, np.zeros(shape, arr.dtype)], dim)
        return torch.cat([arr, arr.new_zeros(shape)], dim)

    def _retire_inflight(self) -> None:
        self._inflight -= 1
        # a freed slot may unblock a queued full bucket right away
        self._pump(self.clock())

    def _dispatch(self, batch: List[Request]) -> None:
        if self.params is None:
            raise RuntimeError(
                "engine has no params — pass params= at construction for "
                "the queue path (or use engine.rollout for trainers)")
        steps = batch[0].num_steps
        bucket = self.grid.pick(len(batch))
        self._account(bucket, steps, len(batch), x0_only=True)
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

    @torch.no_grad()
    def rollout(self, params, cond: torch.Tensor, seed: int,
                sde_mask=None, num_steps: Optional[int] = None, *,
                x_init: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None) -> Trajectory:
        """Trainer-facing batched rollout: cond (B, Lc, D) on the engine's
        device, row i drawing from ``fold_seed(seed, i)``; capacity-sized
        chunks, each padded on the device to its smallest bucket (padded
        lanes take seed 0 and zero rows, and are cut off), and the full
        Trajectory of exactly B rows out.  ``params`` are used as given
        (a trainer's are already laid out by its plan).  ``x_init`` (B,
        Lt, ld) and ``eps`` (T, B, Lt, ld) replace the seeded draws."""
        steps = self._resolve_steps(num_steps)
        B = cond.shape[0]
        seeds = request_seeds(seed, B)
        cap = self.grid.capacity
        chunks: List[Trajectory] = []
        for i in range(0, B, cap):
            c = cond[i:i + cap]
            n = c.shape[0]
            bucket = self.grid.pick(n)
            self._account(bucket, steps, n, x0_only=False)
            draws = {}
            if x_init is not None:
                draws["x_init"] = self._pad(x_init[i:i + cap], bucket)
            if eps is not None:
                draws["eps"] = self._pad(eps[:, i:i + cap], bucket, dim=1)
            traj = self._run(params, self._pad(c, bucket),
                             seeds[i:i + cap] + [0] * (bucket - n), steps,
                             False, sde_mask, **draws)
            if bucket != n:
                traj = traj._replace(xs=traj.xs[:, :n],
                                     logps=traj.logps[:, :n],
                                     cond=traj.cond[:n])
            chunks.append(traj)
        if len(chunks) == 1:
            return chunks[0]
        return chunks[0]._replace(
            xs=torch.cat([t.xs for t in chunks], 1),
            logps=torch.cat([t.logps for t in chunks], 1),
            cond=torch.cat([t.cond for t in chunks], 0))

    # ---------------------------------------------------------------- warmup
    def warmup(self, num_steps_tiers: Optional[Sequence[int]] = None,
               params=None) -> Dict[str, float]:
        """Run every (bucket × step tier) shape once on zero conditions, by
        default every tier in ``step_tiers`` (submit admits nothing
        outside it), so that steady-state serving never compiles: on a
        CUDA device each shape's eager run builds the kernels and library
        handles and its graph is captured (the reference's trace).
        Returns per-shape seconds (eager run + capture, synchronised); the
        total also lands in ``counters['warmup_s']``."""
        if params is None and self.params is None:
            raise RuntimeError("warmup needs params")
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
                self._warmed.add((bucket, steps, True))
                self._note_trace((bucket, steps, True), during_warmup=True)
        self.counters["warmup_s"] += sum(report.values())
        return report

    def graph_report(self) -> Dict[str, Any]:
        """The engine's CUDA graphs: captures (recaptures on new param
        storages included), per SDE-mask pattern too, replays, and for
        each graph its label, launches per replay and eager-run and
        capture seconds, and the shared pool's bytes.  On the CPU nothing
        is captured."""
        g = self._graphs
        if g is None:
            return {"captures": 0, "replays": 0, "graphs": []}
        by_mask: Dict[str, int] = {}
        rows = []
        for e in g.graphs.values():
            sde = e.label.partition("/sde")[2] or "all"
            by_mask[sde] = by_mask.get(sde, 0) + 1
            rows.append({"shape": e.label, "warm_s": e.warm_s,
                         "capture_s": e.capture_s,
                         "launches_per_replay": {
                             k: n for k, n in e.launches.items() if n}})
        return {"captures": g.captures, "captures_by_mask": by_mask,
                "replays": g.replays, "graphs": rows,
                "pool_bytes": g.pool_bytes()}

    # ----------------------------------------------------------------- stats
    @staticmethod
    def _shape_label(shape: tuple) -> str:
        bucket, steps, x0_only = shape
        return f"b{bucket}/s{steps}" + ("" if x0_only else "/traj")

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
            "compiled_shapes": [self._shape_label(s)
                                for s in sorted(self._traced)],
            "warmed_shapes": [self._shape_label(s)
                              for s in sorted(self._warmed)],
            "compiles": c["compiles"],
            "cold_dispatches": c["cold_dispatches"],
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

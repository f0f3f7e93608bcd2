"""Reusable RL training loop with a small callback protocol — the port of
``repro.api.loop``.

One loop serves every entry point: iterate the prompt dataset, fetch
condition embeddings from the :class:`ConditionProvider`, run
``trainer.step``, and fan the metric row out to callbacks.  Checkpointing
saves the trainer's full ``RLState`` (params and AdamW moments), so a
resumed run continues bit-identically.

``trainer.step`` returns device scalars and waits for nothing on the
device; the loop fetches a step's metrics with one host transfer
(``_drain_one``), the only point where the host waits for the device.

Pipelining (``LoopConfig.pipeline``), as the reference's: with
``pipeline=K`` up to K-1 steps are dispatched and not yet drained, so the
host's work for step N+1 (the next prompt batch, its conditions, the
dispatch of its kernels or its graph replay) overlaps step N on the
device.  ``pipeline=1`` is the sequential loop, bitwise; ``pipeline>1``
changes when metrics are observed, never what is computed.  The state is
updated in place and stream order serialises the steps, so K bounds only
the metric lag.  The callback contract is the reference's: callbacks fire
on drained steps, in step order, and one that must see ``trainer.state``
exactly as of its step (``PeriodicCheckpoint``) says so through
``wants_sync``, which drains every in-flight step before anything newer is
dispatched, so a checkpoint taken mid-pipeline resumes bitwise.  After each
dispatch the loop also starts the copy of host-offloaded reward towers
(``trainer.prefetch_reward_params``, ``perf.offload_rewards``).

On a mesh every rank runs the loop over the same prompt batches and gets
the same metrics (the trainer reduces them over the mesh); rank 0 alone
prints, writes the JSON log and writes checkpoints, which hold the
canonical unsharded state (``trainer.canonical_state()``, gathered on
every rank, since the gather is a collective).

Per row, ``dt`` is the step's dispatch→drain wall time in seconds
(unrounded) and ``steps_per_s`` the drained-step rate from the second
step's dispatch on (the first step carries the kernels' build).
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import checkpoint
from repro_torch.distributed.mesh import is_main_process


def _no_sync(loop: "TrainLoop", step: int) -> bool:
    """Default for duck-typed callbacks that don't define ``wants_sync``."""
    return False


class Callback:
    """No-op base; override any subset of the hooks."""

    def on_train_start(self, loop: "TrainLoop") -> None:
        pass

    def on_step(self, loop: "TrainLoop", step: int,
                metrics: Dict[str, Any]) -> None:
        pass

    def wants_sync(self, loop: "TrainLoop", step: int) -> bool:
        """True if ``on_step(step)`` must observe ``trainer.state`` exactly
        as of ``step``: the loop then drains every in-flight step first."""
        return False

    def on_train_end(self, loop: "TrainLoop",
                     history: List[Dict[str, Any]]) -> None:
        pass


class MetricLogger(Callback):
    """Console progress every ``every`` steps (and on the final step)."""

    def __init__(self, every: int = 10):
        self.every = every

    def on_step(self, loop, step, metrics):
        if not is_main_process():
            return
        if self.every and (step % self.every == 0
                           or step == loop.steps - 1):
            sps = metrics.get("steps_per_s", 0.0)
            print(f"  step {step:4d}  reward={metrics['reward']:+.4f}  "
                  f"loss={metrics['loss']:+.4f}  dt={metrics['dt']:.2f}s  "
                  f"{sps:.2f} steps/s", flush=True)


class JSONLogSink(Callback):
    """The full metric history at ``path`` as a JSON array, rewritten
    atomically every ``flush_every`` drained steps and at train end; rows
    of an interrupted earlier run before this run's ``start_step`` are
    kept."""

    def __init__(self, path: str, flush_every: int = 1):
        self.path = path
        self.flush_every = max(1, flush_every)
        self._prior: List[Dict[str, Any]] = []

    def on_train_start(self, loop):
        self._prior = []
        if loop.start_step and os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    rows = json.load(f)
                self._prior = [r for r in rows if r.get("step", -1)
                               < loop.start_step]
            except (ValueError, OSError):
                pass                     # unreadable prior log: start fresh

    def _flush(self, history) -> None:
        if not is_main_process():
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._prior + history, f)
        os.replace(tmp, self.path)

    def on_step(self, loop, step, metrics):
        if len(loop.history) % self.flush_every == 0:
            self._flush(loop.history)

    def on_train_end(self, loop, history):
        if history:
            self._flush(history)


class PeriodicCheckpoint(Callback):
    """Save the trainer's full RLState every ``every`` steps (after a full
    drain: ``wants_sync`` on its save steps)."""

    def __init__(self, ckpt_dir: str, every: int = 50):
        self.ckpt_dir = ckpt_dir
        self.every = every

    def wants_sync(self, loop, step):
        return bool(self.every) and (step + 1) % self.every == 0

    def on_step(self, loop, step, metrics):
        if self.every and (step + 1) % self.every == 0:
            state = loop.trainer.canonical_state()
            if is_main_process():
                checkpoint.save_checkpoint(self.ckpt_dir, step + 1, state)


class EarlyStop(Callback):
    """Stop when ``metric`` hasn't improved by ``min_delta`` for
    ``patience`` consecutive steps (higher is better)."""

    def __init__(self, metric: str = "reward", patience: int = 20,
                 min_delta: float = 0.0):
        self.metric = metric
        self.patience = patience
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.stale = 0

    def on_step(self, loop, step, metrics):
        val = float(metrics[self.metric])
        if self.best is None or val > self.best + self.min_delta:
            self.best, self.stale = val, 0
            return
        self.stale += 1
        if self.stale >= self.patience:
            if is_main_process():
                print(f"[early-stop] {self.metric} stalled at "
                      f"{self.best:+.4f} for {self.patience} steps",
                      flush=True)
            loop.request_stop()


class TrainLoop:
    """Drive ``trainer.step`` over a prompt dataset.

    ``start_step > 0`` resumes: the data stream is fast-forwarded past the
    batches already consumed and step ``it`` samples from ``fold_seed(seed,
    it)``, so a resumed run replays the schedule of an uninterrupted one.
    After each dispatch the loop pulls the next prompt batch, warms its
    conditions on the provider's background worker when the provider has
    ``prefetch``, and starts the reward towers' copy when the trainer has
    ``prefetch_reward_params``, all before draining.  ``pipeline`` is the
    most dispatched-not-yet-drained steps (module docstring)."""

    def __init__(self, trainer, provider, dataset, *, steps: int, seed: int,
                 start_step: int = 0, callbacks: Sequence[Callback] = (),
                 pipeline: int = 1):
        if pipeline < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {pipeline}")
        self.trainer = trainer
        self.provider = provider
        self.dataset = dataset
        self.steps = steps
        self.seed = seed
        self.start_step = start_step
        self.callbacks = list(callbacks)
        self.pipeline = pipeline
        self.history: List[Dict[str, Any]] = []
        self._stop = False
        self._t_window0: Optional[float] = None
        self._n_drained = 0

    def request_stop(self) -> None:
        self._stop = True

    def _stream(self):
        """Prompt-batch iterator positioned past ``start_step`` batches."""
        try:
            return self.dataset.infinite(self.start_step)
        except TypeError:
            stream = self.dataset.infinite()
            for _ in range(self.start_step):
                next(stream)
            return stream

    def _drain_one(self, pending: Deque[Tuple[int, Any, float]]) -> None:
        """Fetch the oldest in-flight step's metrics (one host transfer for
        the whole dict) and fan out the row."""
        it, metrics, t_dispatch = pending.popleft()
        names = sorted(metrics)
        vals = torch.stack([metrics[k].detach().to(torch.float32).reshape(())
                            for k in names]).cpu().tolist()
        m = dict(zip(names, vals))
        now = time.time()
        self._n_drained += 1
        span = (now - self._t_window0
                if self._t_window0 is not None else 0.0)
        sps = ((self._n_drained - 1) / span
               if self._n_drained > 1 and span > 0 else 0.0)
        row: Dict[str, Any] = {
            "step": it,
            "reward": m["reward_mean"],
            "loss": m["loss"],
            "grad_norm": m["grad_norm"],
            "encode_resident": self.provider.encoder_resident,
            "dt": now - t_dispatch,
            "steps_per_s": sps,
        }
        for k, v in m.items():
            if k not in row and k not in ("reward_mean", "loss",
                                          "grad_norm"):
                row[k] = v
        self.history.append(row)
        for cb in self.callbacks:
            cb.on_step(self, it, row)

    def run(self) -> List[Dict[str, Any]]:
        for cb in self.callbacks:
            cb.on_train_start(self)
        self._t_window0 = None
        self._n_drained = 0
        stream = self._stream()
        pending: Deque[Tuple[int, Any, float]] = deque()
        next_prompts: Optional[List[str]] = None
        can_prefetch = hasattr(self.provider, "prefetch")
        can_prefetch_rewards = hasattr(self.trainer,
                                       "prefetch_reward_params")
        for it in range(self.start_step, self.steps):
            if self._stop:
                break
            prompts = next_prompts if next_prompts is not None \
                else next(stream)
            next_prompts = None
            cond = self.provider.get(prompts)["cond"]
            t_dispatch = time.time()
            pending.append((it, self.trainer.step(cond, self.seed, it=it),
                            t_dispatch))
            if it == self.start_step + 1:
                self._t_window0 = t_dispatch
            if it + 1 < self.steps:
                next_prompts = next(stream)
                if can_prefetch:
                    self.provider.prefetch(next_prompts)
            if can_prefetch_rewards:
                self.trainer.prefetch_reward_params()
            barrier = any(getattr(cb, "wants_sync", _no_sync)(self, it)
                          for cb in self.callbacks)
            limit = 0 if barrier else self.pipeline - 1
            while len(pending) > limit:
                self._drain_one(pending)
        while pending:
            self._drain_one(pending)
        for cb in self.callbacks:
            cb.on_train_end(self, self.history)
        return self.history

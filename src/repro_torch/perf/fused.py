"""The fused train step: sample → rewards → advantages → update as one
function, captured into a CUDA graph (the port of ``repro.perf.fused``).

``BaseTrainer.step`` otherwise launches the step's few thousand kernels
one by one from Python.  :class:`FusedStep` runs the trainer's step body
(``BaseTrainer._step_body``: the rollout, under ``no_grad``, so the
trajectory is data to the loss as the reference's ``stop_gradient`` makes
it; the rewards and advantages; the loss, its backward and AdamW) and
returns the step's metrics as device scalars from the same call.

On a CUDA device the first call for a key runs the body eagerly on the
capture stream (this is that step's real update, and it builds every
kernel library and cuBLAS handle the body needs), then captures the body
into a ``torch.cuda.CUDAGraph`` without running it; every later call with
the key is a ``replay()``.  The key is the SDE-mask pattern (``mix_grpo``'s
window moves with ``it``), which draws are injected, and the condition's
shape.  A replay reads static inputs written before it: the condition and
any injected draws (``copy_``), and the learning rate and bias corrections
(``BaseTrainer._begin_update``).  The rollout's and the update's draws come
from persistent ``torch.Generator`` s (the update's: one per microbatch
chunk under ``dist.microbatch``), registered with every graph and
re-seeded before each call as ``BaseTrainer.step`` seeds its fresh ones
(``fold_seed(seed, it)``, ``BaseTrainer.update_generators``), so a replay
draws what the eager step draws.  On a mesh the step's collectives (the
rewards' gather, the gradients' all-reduce, the layers' gathers) are
captured with it: the eager first step has already run each of them on
the group, so the communicators exist before the capture.  The graph's outputs are cloned after each
replay: a pipelined loop reads them after the next replay has been queued.

There is no fallback: a capture that fails raises with the operation CUDA
refused.  On the CPU (only when the caller asks for it) the body runs
eagerly each call.  The kernels' launch counters count the kernels that
ran (``kernels.counts``): a graph keeps the launches its capture counted,
takes them back out of the counters (a captured kernel has not run) and
adds them again at each replay, so a run of n steps with one capture
counts each kernel of the step n times.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.rollout import fold_seed
from repro_torch.kernels import counts

DRAWS = ("x_init", "eps", "update_t", "update_eps")


class _Graph:
    __slots__ = ("graph", "cond", "draws", "out", "launches")

    def __init__(self, graph, cond, draws, out, launches):
        self.graph, self.cond, self.draws, self.out = graph, cond, draws, out
        self.launches = launches


class FusedStep:
    def __init__(self, trainer):
        self.trainer = trainer
        dev = trainer.device
        self.gen_sample = torch.Generator(device=dev)
        k = trainer.dist.microbatch
        self.gen_update = (torch.Generator(device=dev) if k <= 1 else
                           [torch.Generator(device=dev) for _ in range(k)])
        self.captures = 0
        self.replays = 0
        self._graphs: Dict[tuple, _Graph] = {}
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                      else None)

    def __call__(self, cond: torch.Tensor, seed: int, it: int, *,
                 x_init: Optional[torch.Tensor] = None,
                 eps: Optional[torch.Tensor] = None,
                 update_t: Optional[torch.Tensor] = None,
                 update_eps: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
        tr = self.trainer
        draws = {"x_init": x_init, "eps": eps, "update_t": update_t,
                 "update_eps": update_eps}
        mask = tr.sde_mask(it)
        step_seed = fold_seed(seed, it)
        tr._begin_update()
        self.gen_sample.manual_seed(step_seed)
        for gen, s in zip(self._update_gens(), tr.update_seeds(step_seed)):
            gen.manual_seed(s)
        if tr.device.type != "cuda":
            out = tr._step_body(cond, self.gen_sample, self.gen_update, mask,
                                draws)
        else:
            key = (None if mask is None else tuple(bool(m) for m in mask),
                   tuple(k for k in DRAWS if draws[k] is not None),
                   tuple(cond.shape))
            entry = self._graphs.get(key)
            if entry is None:
                out = self._warm_and_capture(key, cond, mask, draws)
            else:
                entry.cond.copy_(cond)
                for k, v in entry.draws.items():
                    v.copy_(draws[k])
                entry.graph.replay()
                counts.add(entry.launches)
                self.replays += 1
                out = {k: v.clone() for k, v in entry.out.items()}
        tr._end_update()
        return out

    def _warm_and_capture(self, key, cond, mask, draws):
        tr, s = self.trainer, self._stream
        cur = torch.cuda.current_stream()
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            static_cond = cond.clone()
            static_draws = {k: v.clone() for k, v in draws.items()
                            if v is not None}
            # the eager step: this step's real update
            metrics = tr._step_body(static_cond, self.gen_sample,
                                    self.gen_update, mask, static_draws)
        cur.wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        for gen in (self.gen_sample, *self._update_gens()):
            graph.register_generator_state(gen)
        before = counts.read()
        with torch.cuda.graph(graph, pool=self._pool, stream=s):
            out = tr._step_body(static_cond, self.gen_sample,
                                self.gen_update, mask, static_draws)
        launches = counts.since(before)
        counts.add(launches, times=-1)
        self._graphs[key] = _Graph(graph, static_cond, static_draws, out,
                                   launches)
        self.captures += 1
        return metrics

    def _update_gens(self):
        return (self.gen_update if isinstance(self.gen_update, list)
                else [self.gen_update])

    def report(self) -> Dict[str, object]:
        """Captures, replays, each graph's kernel launches per replay and
        the graphs' memory pool (CUDA only)."""
        out = {"captures": self.captures, "replays": self.replays,
               "graphs": len(self._graphs),
               "launches_per_replay": [
                   {k: n for k, n in g.launches.items() if n}
                   for g in self._graphs.values()]}
        if self._pool is not None:
            from repro_torch.perf.memory import pool_bytes
            out["pool_bytes"] = pool_bytes(self._pool)
        return out


def make_fused_step(trainer) -> FusedStep:
    """The fused step of ``trainer`` (``perf.fuse_step``)."""
    return FusedStep(trainer)

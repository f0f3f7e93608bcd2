"""CUDA graphs of one body, a graph a key, on one memory pool: the capture
machinery that the fused train step (``perf.fused.FusedStep``) and the
serving engine (``serving.ServingEngine``) share.

:meth:`GraphCache.capture` runs the body once eagerly on the cache's
capture stream (its real result: the kernels build, cuBLAS creates its
handle and workspace for that stream, NCCL its communicators), releases
the blocks that run left cached in the regular allocator, then captures
the body into a ``torch.cuda.CUDAGraph`` without running it.  The body
reads its static inputs (made by :meth:`static_inputs`, on the capture
stream) and, by storage, whatever else it closes over: parameters updated
in place are seen by every replay.  :meth:`replay` copies new values into
the static inputs (``copy_``), replays the graph and returns clones of its
outputs.  Generators given to the cache are registered with every graph,
so a replay draws what the eager body would from their current seeds.

Every cache captures on one stream per device (:func:`capture_stream`):
cuBLAS keeps a workspace for each stream it has run on for the life of
the process, so a stream of its own per cache would hold one more
workspace per engine.  All graphs of a cache share one private memory
pool.  That is safe only
because the replays run one at a time, on the stream of their caller, and
each replay's outputs are cloned before the next replay is queued: a
graph's intermediates may then reuse what another graph's intermediates
used, and no replay overwrites outputs that a caller still reads.  A
graph's own outputs stay allocated in the pool for its next replay.

Launch counts stay true (``kernels.counts``): a capture records the
launches it saw and takes them back out of the counters (a captured kernel
has not run), and each replay adds them again.

There is no fallback: a capture that fails raises with the operation CUDA
refused.  The cache exists only on a CUDA device; its users run their
body eagerly on the CPU.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Hashable, Optional, Sequence

import torch

from repro_torch.kernels import counts


def clone_tree(tree):
    """``tree`` (a tensor, or a dict, tuple, list or NamedTuple of them and
    of other values) with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_tree(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one capture stream of ``device``, made at its first use."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class Captured:
    """One key's graph: its static inputs and outputs, the launches its
    capture counted, the seconds of its eager run and of its capture, and
    what its owner keeps beside it (``meta``)."""

    __slots__ = ("graph", "static", "out", "launches", "warm_s",
                 "capture_s", "label", "meta")

    def __init__(self, graph, static, out, launches, warm_s, capture_s,
                 label, meta):
        self.graph, self.static, self.out = graph, static, out
        self.launches, self.warm_s, self.capture_s = (launches, warm_s,
                                                      capture_s)
        self.label, self.meta = label, meta


class GraphCache:
    """A dict of :class:`Captured` graphs on ``device``, on one pool and
    one capture stream; ``generators`` are registered with each graph."""

    def __init__(self, device, generators: Sequence[torch.Generator] = ()):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got "
                             f"{self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.generators = list(generators)
        self.stream = capture_stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Hashable, Captured] = {}
        self.captures = 0
        self.replays = 0

    def get(self, key: Hashable) -> Optional[Captured]:
        return self.graphs.get(key)

    def static_inputs(self, inputs: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        """Clones of ``inputs`` made on the capture stream: the static
        inputs a body is captured on and a replay copies into."""
        s = self.stream
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s):
            return {k: v.clone() for k, v in inputs.items()}

    def capture(self, key: Hashable, static: Dict[str, torch.Tensor], fn,
                *args, label: str = "", meta: Any = None, **kwargs):
        """``fn(*args, **kwargs)`` run eagerly on the capture stream, then
        captured under ``key`` (replacing a graph held there).  ``static``
        names the static inputs among the arguments.  Returns the eager
        run's result, cloned: it may alias a static input (a rollout
        returns its condition), which the next replay overwrites."""
        s = self.stream
        cur = torch.cuda.current_stream(self.device)
        s.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.stream(s):
            result = fn(*args, **kwargs)
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.graphs.pop(key, None)
        # what the eager run left cached is not the pool's: hand it back
        # before the capture takes the graph's blocks
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = counts.read()
        with torch.cuda.graph(graph, pool=self.pool, stream=s):
            out = fn(*args, **kwargs)
        launches = counts.since(before)
        counts.add(launches, times=-1)
        cur.wait_stream(s)
        self.graphs[key] = Captured(graph, static, out, launches, t1 - t0,
                                    time.perf_counter() - t1, label, meta)
        self.captures += 1
        return clone_tree(result)

    def replay(self, key: Hashable, inputs: Dict[str, torch.Tensor]):
        """Replay ``key``'s graph on ``inputs`` (copied into its static
        inputs by name) and return clones of its outputs."""
        entry = self.graphs[key]
        for k, v in inputs.items():
            entry.static[k].copy_(v)
        entry.graph.replay()
        counts.add(entry.launches)
        self.replays += 1
        return clone_tree(entry.out)

    def pool_bytes(self) -> int:
        from repro_torch.perf.memory import pool_bytes
        return pool_bytes(self.pool)

"""Host memory offload for the train step (``perf.offload_rewards`` /
``perf.remat_offload``), the port of ``repro.perf.offload``.

* **Reward towers** (``offload_rewards``): the frozen reward-model params
  are read only in each step's reward phase.  :func:`offload_param_store`
  parks them in pinned host memory and rebases the loader onto the host
  copies.  Each step then gets a device copy from :func:`prefetch_tree`:
  a non-blocking copy on a side stream, ordered after the work already
  enqueued on the current stream and marked by an event, which the reward
  phase waits on (:func:`wait_tree`).  The TrainLoop starts it right after
  each dispatch, so it overlaps the next step's rollout; the device copy
  is freed after the reward phase, before the backward sets the step's
  peak.  Inside a captured step (``perf.fuse_step``) the same fork and join
  are recorded into the graph.

* **Remat residuals** (``remat_offload``): the reference saves the
  named velocity residual of its checkpointed loss scan to host memory.
  The port's losses keep no scan body (``core.rollout``), and the
  log-density's backward saves no copy of the velocity (its derivative in
  v is a constant), so there is nothing to offload: ``remat_offload``
  runs the program of ``remat="none"`` (``perf.policy``).

On the CPU, host memory is the device's own: the store stays as it is, as
the reference falls back to ``device_get`` there.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_bytes(tree: Any) -> int:
    """Total byte footprint of a tree's tensor leaves (shape arithmetic)."""
    return int(sum(t.numel() * t.element_size() for t in _leaves(tree)))


def offload_tree(tree: Any) -> Any:
    """A tree's CUDA leaves copied to pinned host memory; CPU leaves stay
    as they are."""
    def to_host(t):
        if t.device.type != "cuda":
            return t
        return t.to("cpu").pin_memory()
    return _map(tree, to_host)


class Prefetched(NamedTuple):
    """A device copy of a host tree, valid once ``event`` has passed (None
    on the CPU, where the tree is the host tree itself)."""
    tree: Any
    event: Optional[torch.cuda.Event]


def prefetch_tree(host_tree: Any, device: torch.device,
                  stream: Optional[torch.cuda.Stream] = None) -> Prefetched:
    """Start the copy of a host-offloaded tree to ``device`` and return at
    once.  The destination is allocated on the current stream; ``stream``
    (a side stream) first waits for the current stream's enqueued work,
    which may still use that memory, then copies without blocking the
    host and records the event the reader waits on."""
    if device.type != "cuda":
        return Prefetched(host_tree, None)
    dst = _map(host_tree, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                device=device))
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for d, h in zip(_leaves(dst), _leaves(host_tree)):
            d.copy_(h, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return Prefetched(dst, event)


def wait_tree(pre: Prefetched) -> Any:
    """The prefetched tree, once the current stream has waited for its
    copy."""
    if pre.event is not None:
        torch.cuda.current_stream().wait_event(pre.event)
    return pre.tree


def offload_param_store(loader) -> Dict[str, Any]:
    """Park a :class:`~repro_torch.core.rewards.MultiRewardLoader`'s param
    store in host memory and rebase the loader onto the host copies
    (``bind``, the reference's ``rebase``).
    Returns the host store the trainer copies from each step."""
    host = {mid: offload_tree(p) for mid, p in loader.param_store().items()}
    loader.bind(host)
    return host


def reward_tower_report(trainer) -> Dict[str, Any]:
    """The ``perf.log_memory`` accounting entry for the reward towers,
    computed from their shapes (not measured): their total byte footprint,
    what stays device-resident under the active policy, and the device
    bytes ``offload_rewards`` freed."""
    total = tree_bytes(trainer.loader.param_store())
    off = trainer.offloads_rewards
    return {
        "tower_bytes": total,
        "device_resident_bytes": 0 if off else total,
        "device_bytes_freed": total if off else 0,
        "offloaded": off,
    }

"""Memory introspection for the train step, the port of
``repro.perf.memory``.

XLA's ``compiled.memory_analysis()`` has no PyTorch counterpart, so the
update is measured by running it once, on a trajectory of the step's
shapes, under saved-tensor hooks that count what the autograd graph keeps
for the backward (:class:`SavedBytes`): deterministic, and the same on the
CPU as on the card.  The count follows each saved tensor's storage until
the graph releases it, so ``saved_peak_bytes`` is the most the update's
graphs hold at one time (the port's losses free each timestep's graph at
once).  Parameter storage is left out.  The transient activations of a
block recomputed in the backward (``remat="block"``) are not saved tensors
and are not counted.  On a CUDA device the entry also has
``torch.cuda.max_memory_allocated`` over the run.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.rollout import Trajectory, group_repeat
from repro_torch.distributed.mesh import mesh_dp
from repro_torch.models.params import leaves
from repro_torch.perf.offload import reward_tower_report

F32 = torch.float32


class _Saved:
    __slots__ = ("owner", "key", "t")

    def __init__(self, owner: "SavedBytes", key: int, t: torch.Tensor):
        self.owner, self.key, self.t = owner, key, t

    def __del__(self):
        self.owner._release(self.key)


class SavedBytes:
    """Saved-tensor hooks that count the bytes an autograd graph holds,
    each storage once, outside ``exclude`` (data pointers of storages
    not to count: the parameters)."""

    def __init__(self, exclude=()):
        self.exclude = set(exclude)
        self.live: Dict[int, list] = {}   # storage ptr -> [bytes, refs]
        self.live_bytes = 0
        self.peak_bytes = 0
        self.total_bytes = 0              # every storage saved, once each

    def _pack(self, t: torch.Tensor):
        storage = t.untyped_storage()
        key = storage.data_ptr()
        if key in self.exclude:
            return t
        entry = self.live.get(key)
        if entry is None:
            entry = self.live[key] = [storage.nbytes(), 0]
            self.live_bytes += entry[0]
            self.total_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        return _Saved(self, key, t)

    @staticmethod
    def _unpack(packed):
        return packed.t if isinstance(packed, _Saved) else packed

    def _release(self, key: int) -> None:
        entry = self.live[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self.live[key]

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        self._unpack)


def state_bytes(trainer) -> Dict[str, int]:
    """Param + optimizer byte footprint: on a mesh the ``PartitionPlan``'s
    ``bytes_report`` (the canonical total against what this rank holds),
    without one all of it on the one device."""
    if trainer.plan is not None:
        return trainer.plan.bytes_report(trainer.state)
    total = 0
    for tree in (trainer.state.params, trainer.state.opt.mu,
                 trainer.state.opt.nu):
        total += sum(t.numel() * t.element_size() for _, t in leaves(tree))
    total += trainer.state.opt.step.numel() * \
        trainer.state.opt.step.element_size()
    return {"total_bytes": int(total), "per_device_bytes": int(total),
            "sharded_leaves": 0}


def _probe_trajectory(trainer, cond: torch.Tensor) -> Trajectory:
    """A trajectory of the step's shapes for a (P, Lc, cond_dim) prompt
    batch (on a data mesh, this rank's rows of it), drawn from a fixed seed
    (values do not matter to the count)."""
    f = trainer.flow
    cond_g = group_repeat(cond, f.group_size)
    cond_g = cond_g[:cond_g.shape[0] // mesh_dp(trainer.mesh)]
    B, T, dev = cond_g.shape[0], f.num_steps, cond.device
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = torch.randn((T + 1, B, f.latent_tokens, f.latent_dim),
                     generator=gen, dtype=F32, device=dev)
    mask = trainer.sde_mask(0)
    mask = (torch.ones(T, dtype=torch.bool) if mask is None
            else torch.as_tensor(mask, dtype=torch.bool))
    return Trajectory(xs=xs,
                      logps=torch.zeros((T, B), dtype=F32, device=dev),
                      ts=torch.from_numpy(trainer.scheduler.timesteps(T)),
                      sde_mask=mask, cond=cond_g)


def update_memory(trainer, cond: torch.Tensor) -> Dict[str, Dict]:
    """Run the trainer's update (loss and backward; no optimizer step, the
    gradients are cleared again) once for a (P, Lc, cond_dim) prompt batch
    under :class:`SavedBytes`, and report it with the state's and the
    reward towers' bytes, and the fused step's graphs when
    ``perf.fuse_step`` is on."""
    traj = _probe_trajectory(trainer, cond)
    adv = torch.zeros(traj.cond.shape[0], dtype=F32, device=cond.device)
    params = [p for _, p in leaves(trainer.state.params)]
    counter = SavedBytes(p.untyped_storage().data_ptr() for p in params)
    cuda = cond.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    with counter.hooks():
        trainer.backward(traj, adv, torch.Generator(
            device=cond.device).manual_seed(0))
    for p in params:
        p.grad = None
    update = {"saved_peak_bytes": counter.peak_bytes,
              "saved_total_bytes": counter.total_bytes}
    if cuda:
        torch.cuda.synchronize()
        update["peak_bytes"] = torch.cuda.max_memory_allocated()
        update["peak_above_state_bytes"] = update["peak_bytes"] - base
    out = {"update": update, "state": state_bytes(trainer),
           "reward_towers": reward_tower_report(trainer)}
    if trainer._fused is not None:
        out["fused"] = trainer._fused.report()
    return out


def pool_bytes(pool) -> Optional[int]:
    """Bytes the CUDA caching allocator holds in the private memory pool
    ``pool`` (a ``torch.cuda.graph_pool_handle()``)."""
    segments = torch.cuda.memory_snapshot()
    return int(sum(s["total_size"] for s in segments
                   if tuple(s.get("segment_pool_id", ())) == tuple(pool)))

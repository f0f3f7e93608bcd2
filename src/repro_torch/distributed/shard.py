"""Data-parallel rollouts: each data rank runs its slice of the batch and
the outputs are all-gathered — the port of ``repro.distributed.shard``.

``make_rollout_keyed_sharded`` is the serving engine's executor: cond and
the per-request seeds are split over the "data" ranks, each rank runs
``rollout_keyed`` on its slice, and the latents (or the whole trajectory)
are gathered back in request order.  Each request's draws come from its
own seed and its computation is its own row's, so a request's latent is
what the single-device engine gives it, at any dp.  On a "model" axis
the params are this rank's shards and each layer gathers its slice
(``repro_torch.sharding``); every model rank of a data row runs the same
rows.

``rollout_sharded`` / ``make_rollout_sharded`` are the generation-throughput
entry point: data rank r draws its rows from a generator seeded
``fold_seed(seed, r)`` (the reference folds the key with the axis index),
so the samples are exchangeable with, not equal to, a single-device
rollout of the same seed.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch import sharding as shlib
from repro_torch.core.rollout import (Trajectory, fold_seed, rollout,
                                      rollout_keyed)
from repro_torch.distributed.mesh import data_group, data_rank, mesh_dp


def _gather_traj(traj: Trajectory, group, dp: int) -> Trajectory:
    return Trajectory(
        xs=shlib.gather_dim(traj.xs, 1, group, dp),
        logps=shlib.gather_dim(traj.logps, 1, group, dp),
        ts=traj.ts, sde_mask=traj.sde_mask,
        cond=shlib.gather_dim(traj.cond, 0, group, dp))


def _local(batch: int, mesh, what: str) -> slice:
    dp = mesh_dp(mesh)
    if batch % dp != 0:
        raise ValueError(
            f"{what} batch {batch} is not divisible by the data axis "
            f"({dp} devices)" + (" — bucket sizes must be dp-aligned"
                                 if what == "keyed rollout" else ""))
    n = batch // dp
    r = data_rank(mesh)
    return slice(r * n, (r + 1) * n)


def make_rollout_sharded(adapter, scheduler, num_steps: int, mesh,
                         sde_mask=None):
    """``fn(params, cond, seed) -> Trajectory`` over the whole batch, each
    data rank rolling out its rows from ``fold_seed(seed, rank)``."""

    @torch.no_grad()
    def run(params, cond: torch.Tensor, seed: int) -> Trajectory:
        rows = _local(cond.shape[0], mesh, "rollout")
        gen = torch.Generator(device=cond.device).manual_seed(
            fold_seed(seed, data_rank(mesh)))
        with shlib.param_gather(mesh):
            traj = rollout(adapter, params, cond[rows], gen, scheduler,
                           num_steps, sde_mask)
        return _gather_traj(traj, data_group(mesh), mesh_dp(mesh))

    return run


def rollout_sharded(adapter, params, cond: torch.Tensor, seed: int,
                    scheduler, num_steps: int, mesh,
                    sde_mask=None) -> Trajectory:
    """One-shot :func:`make_rollout_sharded`; without a mesh the plain
    rollout from a generator seeded ``seed``."""
    if mesh is None:
        gen = torch.Generator(device=cond.device).manual_seed(seed)
        return rollout(adapter, params, cond, gen, scheduler, num_steps,
                       sde_mask)
    return make_rollout_sharded(adapter, scheduler, num_steps, mesh,
                                sde_mask)(params, cond, seed)


def make_rollout_keyed_sharded(adapter, scheduler, num_steps: int, mesh,
                               x0_only: bool = False, plan=None):
    """``fn(params, cond, seeds, sde_mask, *, x_init=None, eps=None) ->
    Trajectory`` (or the final latents (B, Lt, ld) with ``x0_only``) over
    the whole bucket, each data rank running its slice of the requests;
    without a mesh the plain ``rollout_keyed``.  The bucket must divide the
    data axis (the engine's grid is dp-aligned).  ``x_init`` / ``eps``, the
    whole bucket's, replace the seeded draws (each rank takes its rows).
    ``plan`` is accepted for the reference's signature: the params arrive
    already laid out by it."""

    @torch.no_grad()
    def run(params, cond: torch.Tensor, seeds: Sequence[int],
            sde_mask: Optional[Sequence[bool]] = None, *,
            x_init: Optional[torch.Tensor] = None,
            eps: Optional[torch.Tensor] = None):
        if mesh is None:
            traj = rollout_keyed(adapter, params, cond, seeds, scheduler,
                                 num_steps, sde_mask, x_init=x_init, eps=eps)
            return traj.x0 if x0_only else traj
        rows = _local(cond.shape[0], mesh, "keyed rollout")
        with shlib.param_gather(mesh):
            traj = rollout_keyed(
                adapter, params, cond[rows], list(seeds)[rows], scheduler,
                num_steps, sde_mask,
                x_init=None if x_init is None else x_init[rows],
                eps=None if eps is None else eps[:, rows])
        group, dp = data_group(mesh), mesh_dp(mesh)
        if x0_only:
            return shlib.all_gather_rows(traj.x0.contiguous(), group, dp)
        return _gather_traj(traj, group, dp)

    return run

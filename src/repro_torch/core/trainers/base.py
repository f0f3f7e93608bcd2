"""BaseTrainer — the paper's algorithm-logic component type (the port of
``repro.core.trainers.base``).

Owns sampling (``rollout``), reward computation (``MultiRewardLoader``),
advantage aggregation and the optimization step.  Subclasses implement
``loss_fn``.  Each rank runs on one device (``device``, default
``cuda``); ``perf`` takes every policy the reference accepts
(``repro_torch.perf``) and ``dist`` every layout (below).

The parameters stay the nested dict of tensors that ``models.params``
builds.  ``_update`` marks the leaves ``requires_grad``, lets ``loss_fn``
run its backward passes (gradients accumulate in the leaves' ``.grad``, in
the parameter dtype), clips them by their global norm, applies AdamW in
place and clears them again, so sampling never sees a leaf that requires
grad.

Randomness: parameters are drawn from a generator seeded with ``seed`` (as
the serving path draws them), the reward towers from their own seeds, and
step ``it`` of ``step(cond, seed, it)`` samples from a generator seeded with
``fold_seed(seed, it)`` and draws the update's randomness (the timesteps
and forward-process noise of the NFT/AWM losses) from one seeded with
``fold_seed(fold_seed(seed, it), 1)``, so a resumed run replays an
uninterrupted one.  ``step`` also takes the rollout's ``x_init`` / ``eps``
and the update's ``update_t`` / ``update_eps`` to replay injected draws.

The step never waits for the device: its host values (the time grid, the
SDE mask, the AdamW counter) stay on the host, a step's learning rate and
bias corrections reach the device as fills (``_begin_update``), and the
metrics stay device scalars, so a pipelined ``TrainLoop`` can dispatch the
next step while this one runs.  With ``perf.fuse_step`` the same step body
runs as a CUDA graph (``repro_torch.perf.fused``).

Layouts (``dist``, ``repro_torch.distributed``).  Without a mesh (``dp x
mp = 1``) no collective runs.  On a (data, model) mesh every rank builds
the same full batch of prompts x groups and keeps its rows (with
``microbatch`` k, its slice of each of the k global chunks, so chunk c
is the same rows at every layout); it draws the whole batch's init latent
and noise (and, per chunk, the update's) and keeps its rows, so every
layout samples the same trajectories.  Rewards are gathered over "data"
so the advantages, GRPO-Guard's RatioNorm mean and every metric are the
full batch's; the gradients are averaged over "data" (and the replicated
leaves over "model") after the backward.  Params and AdamW moments are
sharded over "model" per the ``PartitionPlan`` and gathered a layer at a
time (``repro_torch.sharding``); the global gradient norm sums the
shards' squares over "model".  ``mesh=`` injects a mesh (a one-rank
group's (1, 1) included) in place of the one ``dist`` resolves to.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import distributed, optim, perf as perf_lib, registry
from repro_torch import sharding as shlib
from repro_torch.config import (ArchConfig, DistConfig, FlowRLConfig,
                                OptimConfig, PerfConfig, RewardSpec,
                                check_ported_layout)
from repro_torch.core import schedulers
from repro_torch.core.rewards import MultiRewardLoader, compute_advantages
from repro_torch.core.rollout import (Trajectory, fold_seed, group_repeat,
                                      rollout, rollout_draws)
from repro_torch.device import resolve_device
from repro_torch.models import params as params_lib
from repro_torch.models.flow import FlowAdapter

F32 = torch.float32

# default reward is shape-agnostic (works for any latent geometry)
DEFAULT_REWARDS = (RewardSpec(reward_type="latent_norm", weight=1.0),)


class RLState(NamedTuple):
    params: Dict
    opt: optim.AdamWState


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


class BaseTrainer:
    """Subclass contract: implement ``loss_fn(params, traj, adv, generator,
    t=None, eps=None)``, which runs the backward pass(es) itself and
    returns (loss, aux metrics).  ``generator`` draws the loss's own
    randomness; ``t`` / ``eps`` replace those draws when given."""

    #: GRPO variants sample with an SDE; NFT/AWM force ODE sampling
    rollout_sde: bool = True

    #: losses that compute batch-global statistics (GRPO-Guard's RatioNorm
    #: mean) set this False: gradient-accumulation microbatching would make
    #: them chunk-local (the reference refuses such trainers there)
    microbatch_safe: bool = True

    def __init__(self, arch_cfg: ArchConfig, flow_cfg: FlowRLConfig,
                 opt_cfg: OptimConfig, *, seed: int = 0,
                 cond_dim: int = 512, dtype=torch.bfloat16, device=None,
                 dist: Optional[DistConfig] = None,
                 perf: Optional[PerfConfig] = None, params=None, mesh=None):
        if flow_cfg.group_size < 1:
            raise ValueError(
                f"flow.group_size must be >= 1, got {flow_cfg.group_size}")
        self.perf = perf or PerfConfig()
        self.dist = dist or DistConfig()
        check_ported_layout(self.dist, self.perf)
        if self.dist.microbatch > 1 and not self.microbatch_safe:
            raise ValueError(
                f"{type(self).__name__} computes batch-global loss "
                "statistics and cannot be microbatched: chunked gradient "
                "accumulation would make them chunk-local and change the "
                "training math — set dist.microbatch=0")
        self.device = resolve_device(device)
        self.mesh = (mesh if mesh is not None else
                     distributed.train_mesh(self.dist, self.device.type))
        self.cfg = arch_cfg
        self.flow = flow_cfg
        self.opt_cfg = opt_cfg
        self.adapter = FlowAdapter(
            arch_cfg, flow_cfg, cond_dim,
            policy_dtype=perf_lib.resolve_policy_dtype(self.perf))
        if not self.rollout_sde:
            self.sde_mode = "all_ode"
        elif type(self).sde_mask is BaseTrainer.sde_mask:
            self.sde_mode = "all_sde"
        else:
            self.sde_mode = "mixed"
        sde_type = flow_cfg.sde_type if self.rollout_sde else "ode"
        self.scheduler = schedulers.build(sde_type, flow_cfg.eta)
        spec = self.adapter.spec()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = params_lib.init(spec, gen, dtype, self.device)
        # the PartitionPlan: every leaf replicated, or sharded over "model"
        # (the AdamW moments follow, being made from the shards)
        self.plan = distributed.partition_plan(self.mesh, spec)
        self._dp = distributed.mesh_dp(self.mesh)
        self._mp = distributed.mesh_mp(self.mesh)
        self._sharded = frozenset()
        if self.plan is not None:
            params = self.plan.shard_state(params)
            self._sharded = frozenset(
                path for path, d in params_lib.leaves(self.plan.param_specs())
                if d is not None)
            self._dgroup = distributed.data_group(self.mesh)
            self._mgroup = distributed.model_group(self.mesh)
        self._row_cache: Dict[int, tuple] = {}
        self._draw_rows = None
        self.optimizer = registry.build("optimizer", opt_cfg.optimizer)
        self.state = RLState(params, self.optimizer.init(params))
        specs = flow_cfg.rewards or DEFAULT_REWARDS
        self.loader = MultiRewardLoader(specs, fold_seed(seed, 1),
                                        self.device)
        # perf.offload_rewards: the frozen towers live in pinned host memory
        # and each step's reward phase reads a device copy of them
        self._reward_store_host = None
        self._reward_prefetch = None
        self._copy_stream = None
        if self.perf.offload_rewards:
            self._reward_store_host = perf_lib.offload_param_store(
                self.loader)
            if self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self.device)
        self._lr = optim.make_schedule(opt_cfg)
        # a step's learning rate and bias corrections on the device, and
        # the discrete timestep grid, made once: the step copies nothing
        # from the host
        self._scalars = optim.step_scalars(self.device)
        self._grid = torch.from_numpy(self.scheduler.timesteps(
            flow_cfg.num_steps)[:-1]).to(self.device)
        # no attach_engine yet (ROADMAP Queue 1 item 13); the reference
        # refuses fuse_step with an attached engine, as this must then
        self._fused = (perf_lib.make_fused_step(self) if self.perf.fuse_step
                       else None)

    # --------------------------------------------------------------- layout
    def place_state(self, state: RLState) -> RLState:
        """A canonical (unsharded) RLState laid out for this trainer's
        mesh: each leaf the plan shards sliced to this rank's shard;
        identity without a mesh.  What lets a checkpoint written under one
        layout resume under any other."""
        return state if self.plan is None else self.plan.shard_state(state)

    def canonical_state(self) -> RLState:
        """The state in the canonical unsharded layout (what checkpoints
        hold): the shards all-gathered over "model", a collective over
        the mesh; the live state itself without a mesh or at mp = 1."""
        return (self.state if self.plan is None
                else self.plan.gather_state(self.state))

    def state_slicer(self):
        """``checkpoint.load_checkpoint``'s ``slicer`` for this trainer's
        layout (None without a mesh)."""
        return None if self.plan is None else self.plan.slicer(self.state)

    def _layout(self, B: int) -> tuple:
        """(rows, inverse) for a global batch of B: this rank's rows of it
        (device indices; per microbatch chunk c, the rank's 1/dp of the
        chunk's rows) and the permutation that puts the data ranks'
        gathered rows back in batch order."""
        out = self._row_cache.get(B)
        if out is None:
            dp, r = self._dp, distributed.data_rank(self.mesh)
            k = max(self.dist.microbatch, 1)
            n = B // (k * dp)

            def rows_of(q):
                return [c * (B // k) + q * n + j for c in range(k)
                        for j in range(n)]
            perm = [i for q in range(dp) for i in rows_of(q)]
            inv = sorted(range(B), key=perm.__getitem__)
            out = (torch.tensor(rows_of(r), device=self.device),
                   torch.tensor(inv, device=self.device))
            self._row_cache[B] = out
        return out

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The full batch of a batch-major tensor from the data ranks'
        rows, in batch order."""
        full = shlib.all_gather_rows(x, self._dgroup, self._dp)
        if self._dp == 1:
            return full
        return full[self._layout(full.shape[0])[1]]

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """A loss's mean statistic over the whole batch: the mean over the
        data ranks of their equal-sized rows' means (identity without a
        mesh)."""
        if self.mesh is None:
            return x
        return shlib.all_reduce_mean(x, self._dgroup, self._dp)

    def batch_max(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return x
        return shlib.all_reduce_max(x, self._dgroup)

    def batch_std(self, x: torch.Tensor) -> torch.Tensor:
        """Population std of a (rows,) tensor over the whole batch."""
        if self.mesh is None:
            return x.std(correction=0)
        mu = self.batch_mean(x.mean())
        return torch.sqrt(self.batch_mean(((x - mu) ** 2).mean()))

    # ------------------------------------------------------------- sampling
    def sde_mask(self, it: int):
        return None  # default: all steps stochastic (or all ODE)

    def _sample(self, params, cond_g: torch.Tensor,
                generator: Optional[torch.Generator], sde_mask, *,
                x_init: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None) -> Trajectory:
        """Rollout of the full group-repeated batch ``cond_g``, or on a data
        mesh of this rank's rows of it, from the whole batch's draws."""
        T = self.flow.num_steps
        if self._dp > 1:
            B = cond_g.shape[0]
            rows = self._layout(B)[0]
            x_d, eps_d = rollout_draws(
                self.adapter, generator, B, T, sde_mask,
                sde_mode=self.sde_mode, device=self.device,
                draw_x_init=x_init is None, draw_eps=eps is None)
            x_init = (x_d if x_init is None else x_init.to(self.device))[rows]
            eps = eps_d if eps is None else eps.to(self.device)
            eps = None if eps is None else eps[:, rows]
            cond_g = cond_g[rows]
        return rollout(self.adapter, params, cond_g, generator,
                       self.scheduler, T, sde_mask, sde_mode=self.sde_mode,
                       x_init=x_init, eps=eps)

    def sample(self, params, cond: torch.Tensor,
               generator: Optional[torch.Generator], it: int = 0, *,
               x_init: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None) -> Trajectory:
        """cond: (P, Lc, D) prompt embeddings -> grouped trajectories
        (P·G samples; on a data mesh, this rank's rows of them)."""
        cond_g = group_repeat(cond, self.flow.group_size)
        distributed.check_batch_divisible(cond_g.shape[0], self.mesh,
                                          self.dist.microbatch)
        with shlib.param_gather(self.mesh):
            return self._sample(params, cond_g, generator, self.sde_mask(it),
                                x_init=x_init, eps=eps)

    # -------------------------------------------------------------- rewards
    @property
    def offloads_rewards(self) -> bool:
        """Whether the frozen reward towers live in host memory
        (``perf.offload_rewards``)."""
        return self._reward_store_host is not None

    def prefetch_reward_params(self) -> None:
        """Start the copy of the host-offloaded reward towers for the next
        step (no-op without ``perf.offload_rewards``, with one pending, or
        under ``perf.fuse_step``, whose captured step copies them itself).
        The TrainLoop calls this right after each dispatch, so the copy
        overlaps the in-flight step; the next step's reward phase consumes
        it."""
        if (self._reward_store_host is None or self._fused is not None
                or self._reward_prefetch is not None):
            return
        self._reward_prefetch = perf_lib.prefetch_tree(
            self._reward_store_host, self.device, self._copy_stream)

    def _take_reward_params(self):
        """The pending prefetch of the reward towers if the loop armed
        one, else a copy started now."""
        pre, self._reward_prefetch = self._reward_prefetch, None
        if pre is None:
            pre = perf_lib.prefetch_tree(self._reward_store_host,
                                         self.device, self._copy_stream)
        return pre

    def _rewards(self, x0: torch.Tensor, cond_meta: Dict,
                 reward_params=None
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                            Dict[str, torch.Tensor]]:
        """(raw rewards, advantages, reward stats); the stats (the weighted
        ``reward_mean`` the optimizer ascends and the per-reward means) are
        device scalars.  ``reward_params`` (``perf.offload_rewards``) is the
        towers' prefetched device copy, waited on here.  On a mesh the
        rewards and stats are the full batch's (pointwise towers score
        this rank's rows and the scores are gathered over "data";
        groupwise ones score the gathered batch, whose groups may straddle
        ranks) and the advantages this rank's rows of the full batch's."""
        G = self.flow.group_size
        store = (None if reward_params is None
                 else perf_lib.wait_tree(reward_params))
        weights = self.loader.weight_map()
        if self.mesh is None:
            rew = self.loader.compute_all(x0, cond_meta, group_size=G,
                                          params=store)
        else:
            rew = {name: self._gather_rows(r) for name, r in
                   self.loader.compute_all(x0, cond_meta, group_size=G,
                                           params=store,
                                           kinds=("pointwise",)).items()}
            if self.loader.has_kind("groupwise"):
                full = {k: self._gather_rows(v) for k, v in cond_meta.items()}
                rew.update(self.loader.compute_all(
                    self._gather_rows(x0), full, group_size=G, params=store,
                    kinds=("groupwise",)))
            rew = {name: rew[name] for name in weights}
        adv = compute_advantages(self.flow.advantage_agg, rew, weights, G)
        if self._dp > 1:
            adv = adv[self._layout(adv.shape[0])[0]]
        stats = {f"reward/{name}": r.to(F32).mean()
                 for name, r in rew.items()}
        stats["reward_mean"] = sum(weights[name] * stats[f"reward/{name}"]
                                   for name in rew)
        return rew, adv, stats

    # --------------------------------------------------------------- update
    def loss_fn(self, params, traj: Trajectory, adv: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                t: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def velocity(self, params, x, t, cond):
        # loss-side velocity: block remat checkpoints each backbone layer
        # of the forward the backward runs again
        return self.adapter.velocity(
            params, x, t, cond, remat=perf_lib.block_remat(self.perf.remat))

    def memory_stats(self, cond: torch.Tensor) -> Dict[str, Dict]:
        """The bytes the update's autograd graph saves for the backward
        (and the device peak over it, on CUDA) for a (P, Lc, cond_dim)
        prompt batch, the state's and the reward towers' bytes, and the
        fused step's graphs (``repro_torch.perf.memory``).  Runs the
        update's loss and backward once; the params do not change."""
        return perf_lib.update_memory(self, cond)

    def sample_timesteps(self, generator: Optional[torch.Generator],
                         batch: int, *, draw: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Timestep sampling strategies of the solver-agnostic algorithms
        (paper §3.2), as the reference's ``sample_timesteps``: ``uniform``
        on [0.02, 0.98], ``logit_normal`` (the sigmoid of a standard
        normal) and ``discrete`` (a uniform pick of the rollout's grid
        ``scheduler.timesteps(T)[:-1]``).  Each strategy transforms one base
        variate per sample, drawn from ``generator``: a uniform on [0, 1),
        a standard normal and an integer index respectively.  ``draw``
        replaces it (tests replay the JAX package's variates through it).
        Returns (batch,) float32 on the generator's device."""
        how = self.flow.timestep_sampling
        dev = generator.device if draw is None else draw.device
        if how == "uniform":
            u = draw if draw is not None else torch.rand(
                (batch,), generator=generator, dtype=F32, device=dev)
            # f32 lo and hi - lo, host scalars: u * (hi - lo) + lo, at
            # least lo, as the reference's uniform(minval, maxval)
            lo = np.float32(0.02)
            span = np.float32(0.98) - lo
            return torch.clamp_min(u.to(F32) * float(span) + float(lo),
                                   float(lo))
        if how == "logit_normal":
            z = draw if draw is not None else torch.randn(
                (batch,), generator=generator, dtype=F32, device=dev)
            return torch.sigmoid(z.to(F32))
        if how == "discrete":
            grid = self._grid.to(dev)
            idx = draw if draw is not None else torch.randint(
                0, grid.shape[0], (batch,), generator=generator, device=dev)
            return grid[idx.long()]
        raise ValueError(f"unknown timestep_sampling {how!r}")

    def forward_draws(self, generator: Optional[torch.Generator],
                      x0: torch.Tensor, t: Optional[torch.Tensor] = None,
                      eps: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The draws of a forward-process loss (NFT, AWM): per-sample
        timesteps t (B,) from ``sample_timesteps``, then the noise eps of
        x0's shape, both f32 from ``generator`` in that order (the
        reference's ``k_t, k_eps = split(key)``), unless given.  On a data
        mesh both are drawn for the whole batch (chunk) and this rank's
        rows are kept."""
        n, rows = ((x0.shape[0], None) if self._draw_rows is None
                   else self._draw_rows)
        if t is None:
            t = self.sample_timesteps(generator, n)
            t = t if rows is None else t[rows]
        if eps is None:
            eps = torch.randn((n,) + tuple(x0.shape[1:]), generator=generator,
                              dtype=F32, device=x0.device)
            eps = eps if rows is None else eps[rows]
        return (t.to(device=x0.device, dtype=F32),
                eps.to(device=x0.device, dtype=F32))

    def _chunk_draws(self, d: Optional[torch.Tensor], B: int, k: int):
        """An injected whole-batch update draw (t or eps) as the k chunks'
        pieces this rank's rows take."""
        if d is None:
            return [None] * k
        d = d.to(self.device)
        if self._dp > 1:
            d = d[self._layout(B)[0]]
        return list(torch.chunk(d, k, dim=0))

    def backward(self, traj: Trajectory, adv: torch.Tensor,
                 generator=None, *,
                 t: Optional[torch.Tensor] = None,
                 eps: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Run ``loss_fn`` with the parameter leaves requiring grad; their
        gradients are left in ``.grad`` (zeros for leaves the loss does not
        reach, as JAX returns them).  ``generator``, ``t`` and ``eps`` go to
        the loss's own draws (``t`` / ``eps`` of the whole batch).

        With ``dist.microbatch`` k > 1 the loss runs over k sequential
        chunks (``distributed.accumulated_value_and_grad``), chunk c drawing
        from ``generator[c]`` (a list of k generators; one generator is
        shared by the chunks in turn).  On a mesh the gradients are then
        averaged over "data", and the replicated leaves over "model" too
        (the sharded ones were reduce-scattered by their gathers), and the
        loss is the whole batch's.  Returns (loss, aux)."""
        params = self.state.params
        leaves = [p for _, p in params_lib.leaves(params)]
        k = self.dist.microbatch if self.dist.microbatch > 1 else 1
        B = adv.shape[0] * self._dp
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        if self._dp > 1:
            n = adv.shape[0] // k
            r = distributed.data_rank(self.mesh)
            self._draw_rows = (B // k, torch.arange(
                r * n, (r + 1) * n, device=self.device))
        try:
            with shlib.param_gather(self.mesh):
                if k > 1:
                    gens = (list(generator)
                            if isinstance(generator, (list, tuple))
                            else [generator] * k)
                    loss, aux = distributed.accumulated_value_and_grad(
                        self.loss_fn, params, traj, adv, gens, k,
                        t=self._chunk_draws(t, B, k),
                        eps=self._chunk_draws(eps, B, k))
                else:
                    if isinstance(generator, (list, tuple)):
                        generator = generator[0]
                    loss, aux = self.loss_fn(
                        params, traj, adv, generator,
                        t=self._chunk_draws(t, B, 1)[0],
                        eps=self._chunk_draws(eps, B, 1)[0])
        finally:
            self._draw_rows = None
            for p in leaves:
                p.requires_grad_(False)
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            self._sync_grads()
            loss = self.batch_mean(loss)
        return loss, aux

    def _sync_grads(self) -> None:
        """Average the gradients over "data" (f32), and the replicated
        leaves' over "model" as well."""
        for path, p in params_lib.leaves(self.state.params):
            g = shlib.all_reduce_mean(p.grad, self._dgroup, self._dp)
            if self._mp > 1 and path not in self._sharded:
                g = shlib.all_reduce_mean(g, self._mgroup, self._mp)
            p.grad = g

    def _begin_update(self) -> None:
        """Write the coming optimizer step's learning rate and bias
        corrections into the device scalars ``apply_grads`` reads."""
        step = int(self.state.opt.step) + 1
        optim.write_step_scalars(self._scalars, self.opt_cfg, step,
                                 self._lr(step - 1))

    def _end_update(self) -> None:
        """Advance the host step counter past the step ``_begin_update``
        began."""
        self.state.opt.step.add_(1)

    def apply_grads(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Clip the leaves' ``.grad`` by their global norm (on a "model"
        axis, the shards' squares summed over it), take one optimizer step
        in place (AdamW is elementwise: it runs on the shards, with the
        moments sharded as their params) and clear the gradients: device
        work only, between ``_begin_update`` and ``_end_update``.  Returns
        (grad norm before clipping, learning rate), device scalars."""
        params = self.state.params
        grads = _map(params, lambda p: p.grad)
        _, gnorm = optim.clip_by_global_norm(
            grads, self.opt_cfg.grad_clip, sharded=self._sharded,
            group=self._mgroup if self._sharded else None)
        self.optimizer.apply(params, grads, self.state.opt, self.opt_cfg,
                             self._scalars)
        for _, p in params_lib.leaves(params):
            p.grad = None
        return gnorm, self._scalars.lr.clone()

    def _update(self, traj: Trajectory, adv: torch.Tensor,
                generator=None, *,
                t: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        loss, aux = self.backward(traj, adv, generator, t=t, eps=eps)
        gnorm, lr = self.apply_grads()
        metrics = dict(aux)
        metrics.update(loss=loss, grad_norm=gnorm, lr=lr)
        return metrics

    # ------------------------------------------------------------ iteration
    def update_seeds(self, step_seed: int) -> List[int]:
        """The update's seed(s) for a step seeded ``step_seed``:
        ``fold_seed(step_seed, 1)``, or with ``dist.microbatch`` k > 1 one
        per chunk, chunk c's ``fold_seed(fold_seed(step_seed, 1), c)`` (the
        reference's per-chunk ``fold_in(key, idx)``)."""
        seed_u = fold_seed(step_seed, 1)
        if self.dist.microbatch > 1:
            return [fold_seed(seed_u, c) for c in range(self.dist.microbatch)]
        return [seed_u]

    def update_generators(self, step_seed: int):
        """Generators seeded with :meth:`update_seeds`: one, or a list of
        one per microbatch chunk."""
        gens = [torch.Generator(device=self.device).manual_seed(s)
                for s in self.update_seeds(step_seed)]
        return gens if self.dist.microbatch > 1 else gens[0]

    def _step_body(self, cond: torch.Tensor, gen_sample, gen_update,
                   sde_mask, draws: Dict[str, Optional[torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
        """Rollout -> rewards -> advantages -> update, device work only
        (``step`` and the fused step run it between ``_begin_update`` and
        ``_end_update``)."""
        cond_g = group_repeat(cond, self.flow.group_size)
        distributed.check_batch_divisible(cond_g.shape[0], self.mesh,
                                          self.dist.microbatch)
        with shlib.param_gather(self.mesh):
            traj = self._sample(self.state.params, cond_g, gen_sample,
                                sde_mask, x_init=draws.get("x_init"),
                                eps=draws.get("eps"))
        # the towers' device copy is referenced only inside ``_rewards``,
        # so it is freed before the update's backward sets the peak
        _, adv, reward_stats = self._rewards(
            traj.x0, {"cond": traj.cond},
            self._take_reward_params() if self.offloads_rewards else None)
        metrics = self._update(traj, adv, gen_update,
                               t=draws.get("update_t"),
                               eps=draws.get("update_eps"))
        metrics.update(reward_stats)
        return metrics

    def step(self, cond: torch.Tensor, seed: int, it: int = 0, *,
             x_init: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None,
             update_t: Optional[torch.Tensor] = None,
             update_eps: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        """One full RL iteration: rollout -> rewards -> advantages -> update.

        cond: (P, Lc, cond_dim) prompt embeddings on the trainer's device
        (from the preprocessing cache or a live encoder; on a mesh every
        rank passes the same full batch).  ``x_init`` / ``eps`` replace the
        rollout's draws, ``update_t`` / ``update_eps`` the update's (the
        forward-process losses' timesteps and noise), all of the whole
        batch.  Returns a flat dict of device scalars (loss, grad_norm,
        lr, the trainer's aux metrics, reward_mean and the per-reward
        means), the same on every rank; callers fetch them with one host
        transfer.  With ``perf.fuse_step`` the step is the fused one."""
        if self._fused is not None:
            return self._fused(cond, seed, it, x_init=x_init, eps=eps,
                               update_t=update_t, update_eps=update_eps)
        step_seed = fold_seed(seed, it)
        gen = torch.Generator(device=self.device).manual_seed(step_seed)
        self._begin_update()
        metrics = self._step_body(cond, gen, self.update_generators(step_seed),
                                  self.sde_mask(it), {
                                      "x_init": x_init, "eps": eps,
                                      "update_t": update_t,
                                      "update_eps": update_eps})
        self._end_update()
        return metrics

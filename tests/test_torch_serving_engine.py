"""The port's serving engine as the reference's tests hold it, and training
through it, on the CPU.

* The reference's engine tests (``tests/test_serving.py``), ported against
  ``repro_torch.serving.ServingEngine`` on an injected clock: bucket and
  step grids, remainder and empty batches, admission, deadlines, priority
  classes, weighted-fair dequeue, SLOs, backpressure, warmup, the cond
  cache, submit validation, the trainer opt-in, and the seeded fuzz harness
  over submit/poll/fetch/drain interleavings (``REPRO_FUZZ_SEEDS`` sizes
  its corpus, 25 by default).  Where the reference asserts bitwise equality
  of one request across batch sizes, the port holds it to
  ``_same_request``'s f32 band: its draws are the request's own, bitwise,
  but a matmul may sum in another order at another batch size.  The port
  runs eagerly and compiles nothing, so the reference's "never compiles"
  reads here "every dispatched shape was warmed".
* Parity with the JAX package on replayed draws: ``ServingEngine.rollout``
  in chunks, and ``flow_grpo`` / ``awm`` steps with an engine attached.
* The engine path against the engine-free path, ``attach_engine``'s
  refusals, and ``Experiment.describe()["arch"]`` against the reference's.

The engine tests run a flux_dit narrowed to width 64 (2 blocks), 8 x 8
latents and a 4 x 32 condition, f32, with the adaLN modulation drawn (at
init it is zero and every block the identity).
"""
import dataclasses
import functools
import gc
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import registry as jregistry
from repro.api import Experiment as JExperiment
from repro.config import RunConfig as JRunConfig
from repro.core import schedulers as jsched
from repro.core.rollout import request_keys
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs as tconfigs
from repro_torch import registry as tregistry
from repro_torch.api import Experiment as TExperiment
from repro_torch.config import FlowRLConfig as TFlow
from repro_torch.config import OptimConfig as TOptim
from repro_torch.config import PerfConfig as TPerf
from repro_torch.config import RewardSpec as TSpec
from repro_torch.config import RunConfig as TRunConfig
from repro_torch.core import schedulers as tsched
from repro_torch.core.rollout import (fold_seed, group_repeat, mix_sde_mask,
                                      request_seeds, rollout_keyed)
from repro_torch.models import params as tparams
from repro_torch.models.flow import FlowAdapter
from repro_torch.serving import (AdmissionConfig, BucketGrid, CondCache,
                                 PriorityClass, RetryAfter, ServingEngine,
                                 StepGrid, default_buckets)

from test_torch_serving import _jax_draws
from test_torch_trainers import _replay_two_steps, _trainer_pair, \
    _update_draws
from torch_parity import (COND_DIM, COND_LEN, adapters, normal,
                          params_pair, to_torch)
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

SEED = 7
CD = 32                                  # condition width
ARCH = dataclasses.replace(tconfigs.get_reduced("flux_dit"), d_model=64,
                           n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                           vocab_size=64)
FLOW = TFlow(num_steps=3, latent_tokens=8, latent_dim=8, clip_range=0.2,
             rewards=(TSpec("text_render", 1.0,
                            args={"latent_dim": 8, "latent_tokens": 8,
                                  "cond_dim": CD}),))
ADAPTER = FlowAdapter(ARCH, FLOW, CD)
SCHED = tsched.build("flow_sde", 0.7)
COND = np.random.default_rng(1).standard_normal((7, 4, CD)).astype(
    np.float32)


def _draw_ada(tree, gen):
    for k, v in tree.items():
        if isinstance(v, dict):
            _draw_ada(v, gen)
        elif k == "ada":
            v.copy_(torch.randn(v.shape, generator=gen) * 0.05)
    return tree


PARAMS = _draw_ada(tparams.init(ADAPTER.spec(),
                                torch.Generator().manual_seed(SEED),
                                torch.float32, "cpu"),
                   torch.Generator().manual_seed(SEED + 1))


def _same_request(a, b):
    """One request's latent served at two batch sizes: its draws are its
    own seed's, bitwise, and the latents agree to f32 rounding (the port's
    band across batch sizes, ``tests/test_torch_serving.py``)."""
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5,
                               rtol=1e-5)


def _direct(i, seed, steps=3):
    """Request (COND[i], seed) rolled out alone through ``rollout_keyed``."""
    return rollout_keyed(ADAPTER, PARAMS, torch.from_numpy(COND[i:i + 1]),
                         [seed], SCHED, steps).x0[0].numpy()


class _Clock:
    """Injectable logical clock for deadline tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(**kw):
    kw.setdefault("num_steps", FLOW.num_steps)
    kw.setdefault("max_batch", 4)
    kw.setdefault("cond_len", 4)
    return ServingEngine(ADAPTER, SCHED, kw.pop("params", PARAMS),
                         device="cpu", **kw)


# ------------------------------------------------------------- bucket policy
def test_default_buckets_are_powers_of_two_up_to_max():
    assert default_buckets(8) == (1, 2, 4, 8)
    assert default_buckets(6) == (1, 2, 4, 6)
    assert default_buckets(1) == (1,)
    with pytest.raises(ValueError, match="max_batch"):
        default_buckets(0)


def test_bucket_grid_picks_smallest_covering_tier():
    g = BucketGrid(max_batch=8)
    assert [g.pick(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
    with pytest.raises(ValueError, match="exceed"):
        g.pick(9)
    with pytest.raises(ValueError, match="bucket"):
        g.pick(0)


def test_bucket_grid_dp_alignment():
    """Sharded serving needs equal per-rank slices: tiers round up to
    multiples of dp and collapse duplicates."""
    g = BucketGrid(max_batch=8, dp=4)
    assert g.sizes == (4, 8)
    assert g.pick(1) == 4 and g.pick(5) == 8
    g = BucketGrid([3, 5, 6], dp=2)
    assert g.sizes == (4, 6)


def test_bucket_grid_alignment_never_raises_memory_cap():
    """max_batch is a memory bound: dp alignment clamps down to the largest
    dp multiple <= the cap (dp itself only below one lane per rank)."""
    assert BucketGrid(max_batch=6, dp=4).sizes == (4,)
    assert BucketGrid(max_batch=11, dp=4).sizes == (4, 8)
    assert BucketGrid([3], dp=4).sizes == (4,)
    with pytest.raises(ValueError, match="max_batch"):
        BucketGrid([16], max_batch=8)


def test_step_grid_admits_only_warmed_tiers():
    g = StepGrid((4, 8), default=8)
    assert g.sizes == (4, 8)
    assert g.resolve(None) == 8 and g.resolve(4) == 4
    with pytest.raises(ValueError, match="step-tier grid"):
        g.resolve(6)
    assert StepGrid((2,), default=3).sizes == (2, 3)
    with pytest.raises(ValueError, match=">= 1"):
        StepGrid((0,), default=3)


# --------------------------------------------------- batch shape correctness
def test_remainder_batch_returns_exactly_n_outputs():
    """7 requests through max_batch=4: one full bucket and a padded
    remainder; exactly 7 latents come back, in request order."""
    eng = _engine()
    lat = eng.serve(COND, SEED)
    assert tuple(lat.shape) == (7, 8, 8)
    assert torch.isfinite(lat).all()
    stats = eng.stats
    assert stats["dispatches"] == {"b4/s3": 2}
    assert stats["padded_lanes"] == 1
    seeds = request_seeds(SEED, 7)
    eng2 = _engine()
    h = eng2.submit(cond=COND[5], seed=seeds[5])
    eng2.drain()
    _same_request(lat[5], h.result())


def test_serve_empty_request_list_returns_empty_batch():
    eng = _engine()
    lat = eng.serve([])
    assert tuple(lat.shape) == (0, 8, 8) and lat.dtype == torch.float32
    lat = eng.serve(np.zeros((0, 4, CD), np.float32), SEED)
    assert tuple(lat.shape) == (0, 8, 8)
    assert eng.stats["requests"] == 0 and eng.stats["dispatches"] == {}


def _admission(**kw):
    kw.setdefault("classes", (
        PriorityClass("interactive", weight=4, max_depth=8, slo_s=0.3),
        PriorityClass("standard", weight=2, max_depth=6),
        PriorityClass("batch", weight=1, max_depth=5),
    ))
    return AdmissionConfig(**kw)


def test_serve_drives_queue_past_admission_bounds():
    """A synchronous serve of more requests than max_inflight x capacity +
    the class depth bound drives its own queue on backpressure: any N
    serves, each request as an unconstrained engine serves it."""
    eng = _engine(max_inflight=1, admission=_admission())
    cond = np.random.default_rng(3).standard_normal((24, 4, CD)).astype(
        np.float32)
    lat = eng.serve(cond, SEED)
    assert tuple(lat.shape) == (24, 8, 8)
    assert eng.pending() == 0
    _same_request(lat, _engine().serve(cond, SEED))


def test_per_request_determinism_across_batching():
    """The same request seed gives the same latent whatever bucket grid,
    max_batch or batch mates it is served with."""
    lat_a = _engine(max_batch=4).serve(COND, SEED)
    _same_request(lat_a, _engine(max_batch=2).serve(COND, SEED))
    _same_request(lat_a, _engine(max_batch=8, buckets=(3, 7, 8)).serve(
        COND, SEED))
    perm = [3, 0, 6, 1, 5, 2, 4]
    seeds = request_seeds(SEED, 7)
    eng = _engine(max_batch=4)
    handles = [eng.submit(cond=COND[i], seed=seeds[i]) for i in perm]
    eng.drain()
    for j, i in enumerate(perm):
        _same_request(handles[j].result(), lat_a[i])


def test_rollout_keyed_masked_steps_integrate_plain_flow():
    """An sde_mask=False step follows step_ode (x - v·Δ), not the SDE
    drift mean, and records a zero log-prob."""
    mask = mix_sde_mask(3, 2)                     # [SDE, SDE, ODE]
    seeds = request_seeds(SEED, 4)
    cond = torch.from_numpy(COND[:4])
    traj = rollout_keyed(ADAPTER, PARAMS, cond, seeds, SCHED, 3, mask)
    for j in range(3):
        t, t_next = float(traj.ts[j]), float(traj.ts[j + 1])
        v = ADAPTER.velocity(PARAMS, traj.xs[j], torch.full((4,), t), cond)
        x_ode = SCHED.step_ode(v, traj.xs[j], t, t_next)
        if bool(mask[j]):
            assert not torch.allclose(traj.xs[j + 1], x_ode, atol=1e-5)
            assert (traj.logps[j] != 0).all()
        else:
            np.testing.assert_allclose(traj.xs[j + 1].numpy(),
                                       x_ode.numpy(), atol=1e-6, rtol=1e-6)
            assert (traj.logps[j] == 0).all()


def test_rollout_keyed_batch_composition_invariance():
    """Any sub-batch of (cond, seed) rows gives the same per-row
    trajectories (to the f32 band across batch sizes)."""
    seeds = request_seeds(SEED, 5)
    cond = torch.from_numpy(COND[:5])
    full = rollout_keyed(ADAPTER, PARAMS, cond, seeds, SCHED, 3)
    sub = rollout_keyed(ADAPTER, PARAMS, cond[1:4], seeds[1:4], SCHED, 3)
    _same_request(full.xs[:, 1:4], sub.xs)
    np.testing.assert_allclose(full.logps[:, 1:4].numpy(),
                               sub.logps.numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="seeds"):
        rollout_keyed(ADAPTER, PARAMS, cond, seeds[:4], SCHED, 3)


# ----------------------------------------------------- admission & deadlines
def test_full_bucket_dispatches_immediately():
    clk = _Clock()
    eng = _engine(deadline_s=1e9, clock=clk)
    seeds = request_seeds(SEED, 4)
    handles = [eng.submit(cond=COND[i], seed=seeds[i]) for i in range(4)]
    assert all(h.done for h in handles)
    assert eng.pending() == 0
    assert eng.stats["dispatches"] == {"b4/s3": 1}


def test_partial_bucket_waits_for_deadline_then_flushes():
    clk = _Clock()
    eng = _engine(deadline_s=0.5, clock=clk)
    seeds = request_seeds(SEED, 2)
    handles = [eng.submit(cond=COND[i], seed=seeds[i]) for i in range(2)]
    assert not any(h.done for h in handles) and eng.pending() == 2
    clk.t = 0.4
    assert eng.poll() == 0
    assert eng.pending() == 2
    clk.t = 0.6
    assert eng.poll() == 2
    assert all(h.done for h in handles)
    assert eng.stats["dispatches"] == {"b2/s3": 1}
    with pytest.raises(RuntimeError, match="not been served"):
        _engine(clock=_Clock(), deadline_s=1e9) \
            .submit(cond=COND[0], seed=seeds[0]).result()


def test_drain_flushes_everything_regardless_of_deadline():
    eng = _engine(deadline_s=1e9, clock=_Clock())
    handles = [eng.submit(cond=COND[i], seed=i) for i in range(3)]
    assert eng.drain() == 3 and all(h.done for h in handles)


def test_num_steps_tiers_are_separate_buckets():
    eng = _engine(step_tiers=(2, 3))
    h3 = eng.submit(cond=COND[0], seed=0)
    h2 = eng.submit(cond=COND[1], seed=1, num_steps=2)
    eng.drain()
    assert h3.result().shape == h2.result().shape == (8, 8)
    assert set(eng.stats["dispatches"]) == {"b1/s3", "b1/s2"}
    assert not np.array_equal(h3.result(), h2.result())


def test_submit_rejects_num_steps_outside_step_grid():
    eng = _engine(step_tiers=(2, 3))
    with pytest.raises(ValueError, match="step-tier grid"):
        eng.submit(cond=COND[0], seed=0, num_steps=7)
    with pytest.raises(ValueError, match="step-tier grid"):
        eng.submit(cond=COND[0], seed=0, num_steps=0)
    assert eng.pending() == 0


def test_submit_rejects_cond_shape_outside_warmed_grid():
    eng = _engine()
    with pytest.raises(ValueError, match=rf"\(4, {CD}\)"):
        eng.submit(cond=np.zeros((5, CD), np.float32), seed=0)
    with pytest.raises(ValueError, match=rf"\(4, {CD}\)"):
        eng.submit(cond=np.zeros((4, 16), np.float32), seed=0)
    assert eng.pending() == 0


def test_auto_seeds_do_not_collide_with_seeds_or_across_engines():
    """An auto seed is a fold_seed chain off a per-engine base: it never
    equals a user seed of the same rid, nor another engine's auto seed."""
    eng = _engine()
    h_auto = eng.submit(cond=COND[0])
    h_seed = eng.submit(cond=COND[0], seed=h_auto.rid)
    eng.drain()
    assert not np.allclose(h_auto.result(), h_seed.result())
    eng2 = _engine()
    h_auto2 = eng2.submit(cond=COND[0])
    eng2.drain()
    assert h_auto2.rid == h_auto.rid
    assert not np.allclose(h_auto.result(), h_auto2.result())
    h_seed2 = eng2.submit(cond=COND[0], seed=0)
    eng2.drain()
    h_seed1 = eng.submit(cond=COND[0], seed=0)
    eng.drain()
    np.testing.assert_array_equal(h_seed1.result(), h_seed2.result())


def test_auto_seeds_match_fold_seed_chain():
    """The port's counterpart of the reference's host-side auto-key
    blocks: the auto seed of request ``rid`` is ``fold_seed(base, rid)``,
    with a base distinct per engine."""
    eng, eng2 = _engine(), _engine()
    assert eng._base_seed != eng2._base_seed
    handles = [eng.submit(cond=COND[0]) for _ in range(6)]
    assert [h.seed for h in handles] == [fold_seed(eng._base_seed, h.rid)
                                         for h in handles]
    assert len({h.seed for h in handles}) == 6


# ------------------------------------------- multi-tenant admission control
def test_admission_config_validation():
    with pytest.raises(ValueError, match="default_class"):
        AdmissionConfig(default_class="nope")
    with pytest.raises(ValueError, match="duplicate"):
        AdmissionConfig(classes=(PriorityClass("a"), PriorityClass("a")),
                        default_class="a")
    with pytest.raises(ValueError, match="weight"):
        PriorityClass("x", weight=0)
    with pytest.raises(ValueError, match="max_depth"):
        PriorityClass("x", max_depth=0)
    eng = _engine(admission=_admission())
    with pytest.raises(ValueError, match="unknown priority class"):
        eng.submit(cond=COND[0], seed=0, priority="platinum")
    with pytest.raises(ValueError, match="slo_s"):
        eng.submit(cond=COND[0], seed=0, slo_s=-1.0)
    with pytest.raises(ValueError, match="max_inflight"):
        _engine(max_inflight=0)


def test_over_capacity_submit_rejected_with_structured_retry_after():
    """Once a priority class is at its depth bound, submit raises a
    structured, JSON-ready RetryAfter with a deterministic hint; after a
    flush frees the queue, the retry succeeds."""
    clk = _Clock()
    eng = _engine(admission=_admission(), deadline_s=0.5, clock=clk,
                  max_inflight=1)
    # held: dropped handles would retire the slot through GC
    blockers = [eng.submit(cond=COND[i], seed=i) for i in range(4)]
    assert eng.stats["inflight"] == 1
    handles = [eng.submit(cond=COND[i % 7], seed=10 + i, priority="batch")
               for i in range(5)]
    with pytest.raises(RetryAfter) as ei:
        eng.submit(cond=COND[0], seed=99, priority="batch")
    err = ei.value
    assert (err.priority, err.depth, err.limit) == ("batch", 5, 5)
    payload = err.to_json()
    assert json.loads(json.dumps(payload)) == payload
    assert payload["error"] == "over_capacity"
    assert payload["retry_after_s"] == pytest.approx(0.5)
    eng.submit(cond=COND[0], seed=50, priority="interactive")
    assert eng.stats["priorities"]["batch"]["rejected"] == 1
    clk.t = 0.6
    eng.poll()
    assert eng.pending() == 0
    h = eng.submit(cond=COND[0], seed=99, priority="batch")
    clk.t = 2.0
    eng.poll()
    assert h.done and all(x.done for x in handles + blockers)


def test_weighted_fair_dequeue_across_tenants_and_classes():
    """Under contention the freed batch is filled by stride scheduling:
    interactive (weight 4) gets both its requests in, the backlogged batch
    tenant the remaining lanes, and is not starved."""
    clk = _Clock()
    eng = _engine(admission=_admission(), deadline_s=1e9, clock=clk,
                  max_inflight=1)
    first = [eng.submit(cond=COND[i], seed=i) for i in range(4)]
    assert all(h.done for h in first)
    heavy = [eng.submit(cond=COND[i % 7], seed=10 + i, priority="batch",
                        tenant="miner") for i in range(5)]
    light = [eng.submit(cond=COND[i], seed=30 + i, priority="interactive",
                        tenant="human") for i in range(2)]
    assert eng.pending() == 7
    first[0].result()
    assert sum(h.done for h in light) == 2
    assert sum(h.done for h in heavy) == 2
    assert eng.stats["served_by_tenant"]["human"] == 2
    clk.t = 1e12
    eng.poll()
    assert all(h.done for h in heavy)


def test_slo_deadline_flushes_before_batching_deadline():
    clk = _Clock()
    eng = _engine(admission=_admission(), deadline_s=0.5, clock=clk)
    h = eng.submit(cond=COND[0], seed=0, priority="interactive")
    clk.t = 0.2
    assert eng.poll() == 0 and not h.done
    clk.t = 0.35
    assert eng.poll() == 1 and h.done
    assert eng.stats["slo_misses"] == {"interactive": 1}
    h2 = eng.submit(cond=COND[1], seed=1, priority="interactive", slo_s=5.0)
    clk.t = 0.75
    assert eng.poll() == 0 and not h2.done
    clk.t = 0.9
    assert eng.poll() == 1 and h2.done
    assert eng.stats["slo_misses"] == {"interactive": 1}


def test_backpressure_bounds_inflight_and_retires_on_fetch():
    clk = _Clock()
    eng = _engine(deadline_s=1e9, clock=clk, max_inflight=1)
    a = [eng.submit(cond=COND[i], seed=i) for i in range(4)]
    b = [eng.submit(cond=COND[i], seed=10 + i) for i in range(4)]
    assert all(h.done for h in a) and not any(h.done for h in b)
    assert eng.stats["inflight"] == 1 and eng.pending() == 4
    a[0].result()
    assert all(h.done for h in b)
    assert eng.pending() == 0
    c = [eng.submit(cond=COND[i], seed=20 + i) for i in range(2)]
    assert eng.drain() == 2 and all(h.done for h in c)


def test_abandoned_handles_release_inflight_slots_on_gc():
    clk = _Clock()
    eng = _engine(deadline_s=1e9, clock=clk, max_inflight=1)
    abandoned = [eng.submit(cond=COND[i], seed=i) for i in range(4)]
    assert all(h.done for h in abandoned)
    assert eng.stats["inflight"] == 1
    queued = [eng.submit(cond=COND[i], seed=10 + i) for i in range(4)]
    assert not any(h.done for h in queued)
    del abandoned
    gc.collect()
    assert all(h.done for h in queued)
    assert eng.stats["inflight"] == 1
    queued[0].result()
    assert eng.stats["inflight"] == 0


def test_poll_deadline_flush_bounded_per_call():
    """Deadline flushes bypass max_inflight through a window of at most
    2 * max_inflight dispatches per poll; the backlog drains over
    successive polls."""
    clk = _Clock()
    eng = _engine(deadline_s=0.1, clock=clk, max_inflight=1)
    blocker = [eng.submit(cond=COND[i], seed=i) for i in range(4)]
    assert all(h.done for h in blocker) and eng.stats["inflight"] == 1
    burst = [eng.submit(cond=COND[i % 7], seed=100 + i) for i in range(12)]
    clk.t = 1.0
    eng.poll()
    assert sum(h.done for h in burst) == 8
    assert eng.stats["inflight"] == 3 and eng.pending() == 4
    eng.poll()
    assert all(h.done for h in burst) and eng.pending() == 0


def test_stats_snapshot_is_json_serializable():
    eng = _engine(step_tiers=(2, 3), admission=_admission())
    eng.warmup()
    eng.serve(COND, SEED)
    eng.submit(cond=COND[0], seed=0, num_steps=2, priority="interactive",
               tenant="acme")
    eng.drain()
    s = eng.stats
    assert json.loads(json.dumps(s)) == s
    assert s["dispatches"] == {"b4/s3": 2, "b1/s2": 1}
    assert set(s["warmed_shapes"]) >= {"b1/s2", "b4/s3"}
    assert s["priorities"]["interactive"]["admitted"] == 1
    assert s["served_by_tenant"] == {"default": 7, "acme": 1}
    assert s["step_tiers"] == [2, 3]


# ------------------------------------------------------------ warmup & cache
def test_warmup_runs_the_grid_so_every_dispatch_is_warmed():
    eng = _engine()
    report = eng.warmup()
    assert set(report) == {"b1/s3", "b2/s3", "b4/s3"}
    assert all(dt > 0 for dt in report.values())
    eng.serve(COND, SEED)
    stats = eng.stats
    assert set(stats["dispatches"]) <= set(stats["warmed_shapes"])
    assert stats["warmup_s"] > 0
    cold = _engine()
    cold.serve(COND, SEED)
    assert cold.stats["warmed_shapes"] == []
    assert cold.stats["dispatches"] == {"b4/s3": 2}


def test_warmup_covers_every_step_tier_by_default():
    eng = _engine(step_tiers=(2, 3))
    report = eng.warmup()
    assert set(report) == {"b1/s2", "b2/s2", "b4/s2",
                           "b1/s3", "b2/s3", "b4/s3"}
    for steps in (2, 3):
        for i in range(5):
            eng.submit(cond=COND[i], seed=i, num_steps=steps)
    eng.drain()
    assert set(eng.stats["dispatches"]) <= set(eng.stats["warmed_shapes"])


def test_cond_cache_skips_encoder_for_repeat_prompts():
    from repro_torch.core.preprocess import ConditionProvider
    provider = ConditionProvider(
        preprocessing=False, device="cpu",
        encoder_kw=dict(cond_dim=CD, cond_len=4, vocab=256, hidden=32))
    eng = _engine(provider=provider)
    lat1 = eng.serve(["a fox", "a robot", "a fox"], SEED)
    assert eng.stats["cond_cache"] == {"hits": 1, "misses": 2, "entries": 2}
    lat2 = eng.serve(["a fox", "a robot", "a fox"], SEED)
    cc = eng.stats["cond_cache"]
    assert cc["hits"] == 4 and cc["misses"] == 2
    np.testing.assert_array_equal(lat1.numpy(), lat2.numpy())


def test_cond_cache_lru_eviction():
    c = CondCache(max_entries=2)
    c.put("a", np.zeros(1))
    c.put("b", np.ones(1))
    assert c.get("a") is not None
    c.put("c", np.ones(1))
    assert c.get("b") is None and len(c) == 2
    assert c.get("a") is not None and c.get("c") is not None


def test_submit_validation():
    eng = _engine()
    with pytest.raises(ValueError, match="exactly one"):
        eng.submit()
    with pytest.raises(ValueError, match="exactly one"):
        eng.submit(cond=COND[0], prompt="both")
    with pytest.raises(ValueError, match="Lc, cond_dim"):
        eng.submit(cond=COND)
    with pytest.raises(ValueError, match="ConditionProvider"):
        eng.submit(prompt="no provider attached")


def test_engine_without_params_refuses_the_queue_path_and_warmup():
    """A trainer's engine holds no params: the queue path and warmup
    refuse with the reference's texts, the rollout takes them per call."""
    eng = _engine(params=None)
    with pytest.raises(RuntimeError, match="engine has no params — pass "
                       "params= at construction"):
        eng.serve(COND[:4], SEED)
    with pytest.raises(RuntimeError, match="warmup needs params"):
        _engine(params=None).warmup()
    traj = _engine(params=None).rollout(PARAMS, torch.from_numpy(COND[:2]),
                                        SEED)
    assert tuple(traj.xs.shape) == (4, 2, 8, 8)


# ------------------------------------------------------------ trainer opt-in
def _trainer(name="flow_grpo", group_size=8, perf=None, **kw):
    flow = dataclasses.replace(FLOW, group_size=group_size, **kw)
    return tregistry.build("trainer", name, ARCH, flow,
                           TOptim(lr=1e-3, total_steps=8, warmup_steps=2),
                           seed=SEED, cond_dim=CD, dtype=torch.float32,
                           device="cpu", perf=perf)


def test_for_trainer_shares_the_trainers_components():
    tr = _trainer()
    eng = ServingEngine.for_trainer(tr, max_batch=8, cond_len=4)
    assert (eng.adapter, eng.scheduler, eng.num_steps, eng.device,
            eng.mesh, eng.plan, eng.params) == (
        tr.adapter, tr.scheduler, FLOW.num_steps, tr.device, None, None,
        None)


def test_trainer_attach_engine_end_to_end():
    """Online RL sampling through the engine: the same Trajectory
    contract, per-request seeded, finite metrics through a full step; the
    rollout of step ``it`` seeded ``fold_seed(fold_seed(seed, it), 0)``."""
    tr = _trainer()
    eng = ServingEngine.for_trainer(tr, max_batch=8, cond_len=4)
    tr.attach_engine(eng)
    cond = torch.from_numpy(
        np.random.default_rng(2).standard_normal((3, 4, CD)).astype(
            np.float32))
    m = tr.step(cond, SEED, it=0)
    assert np.isfinite(float(m["loss"]))
    assert np.isfinite(float(m["reward_mean"]))
    # 3 prompts x group 8 = 24 rollouts -> 3 capacity-8 chunks, no padding
    assert eng.stats["dispatches"] == {"b8/s3": 3}
    assert eng.stats["padded_lanes"] == 0
    gen = torch.Generator().manual_seed(fold_seed(SEED, 1))
    traj = tr.sample(tr.state.params, cond, gen, it=1)
    seeds = request_seeds(fold_seed(fold_seed(SEED, 1), 0), 24)
    direct = rollout_keyed(tr.adapter, tr.state.params,
                           group_repeat(cond, 8), seeds, tr.scheduler, 3)
    # 24 rows in one call against three chunks of 8: the reference's band
    np.testing.assert_allclose(traj.xs.numpy(), direct.xs.numpy(),
                               atol=1e-5, rtol=1e-3)
    tr.attach_engine(None)
    traj2 = tr.sample(tr.state.params, cond, gen, it=1)
    assert traj2.xs.shape == traj.xs.shape
    assert eng.stats["dispatches"] == {"b8/s3": 6}


class _OneRankMesh:
    """A stand-in (data, model) mesh of sizes 1 x 1 that is not the
    trainer's."""

    def size(self, dim):
        return 1


def test_attach_engine_rejects_mismatched_components():
    """num_steps, the scheduler (type and η), the mesh and fuse_step are
    checked, with the reference's texts; None detaches."""
    tr = _trainer()
    with pytest.raises(ValueError, match=r"engine.num_steps=5 != trainer "
                       r"num_steps=3"):
        tr.attach_engine(_engine(num_steps=5))
    with pytest.raises(ValueError, match="engine scheduler .* != trainer "
                       "scheduler .* — rollout dynamics and the update's "
                       "logprob must match"):
        tr.attach_engine(ServingEngine(
            ADAPTER, tsched.build("dance_sde", 0.3), PARAMS, device="cpu",
            num_steps=3, cond_len=4))
    with pytest.raises(ValueError, match="scheduler"):
        tr.attach_engine(ServingEngine(
            ADAPTER, tsched.build("flow_sde", 0.1), PARAMS, device="cpu",
            num_steps=3, cond_len=4))
    with pytest.raises(ValueError, match="engine mesh .* != trainer mesh "
                       "None — build via ServingEngine.for_trainer"):
        tr.attach_engine(_engine(mesh=_OneRankMesh()))
    assert tr._engine is None
    tr.attach_engine(_engine())
    assert tr._engine is not None
    tr.attach_engine(None)
    assert tr._engine is None
    fused = _trainer(perf=TPerf(fuse_step=True))
    with pytest.raises(ValueError, match="perf.fuse_step and an attached "
                       "serving engine are mutually exclusive"):
        fused.attach_engine(ServingEngine.for_trainer(fused, cond_len=4))
    # the schedulers compare as the reference's dataclasses do
    assert tsched.build("flow_sde", 0.7) == tsched.build("flow_sde", 0.7)
    assert tsched.build("ode", 0.0) != tsched.build("dance_sde", 0.0)


def test_engine_rollout_chunking_matches_single_dispatch():
    """B > capacity runs in capacity slices; the concatenated Trajectory
    equals one unchunked keyed rollout, xs and logps to the f32 band of
    another batch size (the reference's own chunking is one f32 ulp off
    in its logps), cond bitwise."""
    eng = _engine(max_batch=4)
    cond = torch.from_numpy(COND[:6])
    traj = eng.rollout(PARAMS, cond, SEED)
    direct = rollout_keyed(ADAPTER, PARAMS, cond, request_seeds(SEED, 6),
                           SCHED, 3)
    _same_request(traj.xs, direct.xs)
    np.testing.assert_allclose(traj.logps.numpy(), direct.logps.numpy(),
                               rtol=1e-5)
    assert torch.equal(traj.cond, direct.cond)
    assert eng.stats["dispatches"] == {"b4/s3": 1, "b2/s3": 1}
    assert eng.stats["padded_lanes"] == 0


def test_engine_rollout_pads_lanes_that_never_reach_a_row():
    """A remainder chunk padded to its bucket (5 = 4 + 1, on one bucket
    of 4): padded lanes take seed 0 and zero rows, and the rows that come
    back are the unpadded rollout's."""
    eng = _engine(max_batch=4, buckets=(4,))
    cond = torch.from_numpy(COND[:5])
    traj = eng.rollout(PARAMS, cond, SEED)
    assert tuple(traj.xs.shape) == (4, 5, 8, 8)
    assert eng.stats["dispatches"] == {"b4/s3": 2}
    assert eng.stats["padded_lanes"] == 3
    alone = rollout_keyed(ADAPTER, PARAMS, cond[4:],
                          request_seeds(SEED, 5)[4:], SCHED, 3)
    _same_request(traj.xs[:, 4:], alone.xs)


# ------------------------------------------------ parity with the JAX package
def test_engine_rollout_matches_jax_on_replayed_draws():
    """B = 6 through ``max_batch=4`` (4 + 2) in both packages, the port on
    the JAX engine's per-request draws (``request_keys``) replayed through
    ``x_init`` / ``eps``; then the port's one chunk against 4 + 2."""
    ja, ta = adapters("flow_sde", 0.7, num_steps=3)
    jp, tp = params_pair(ja, jnp.float32)
    (cond,) = normal(4, (6, COND_LEN, COND_DIM))
    key = jax.random.PRNGKey(3)
    je = JServingEngine(ja, jsched.build("flow_sde", 0.7), None,
                        num_steps=3, max_batch=4, cond_len=COND_LEN)
    want = je.rollout(jp, jnp.asarray(cond), key)
    x_init, eps = map(to_torch, _jax_draws(ja, request_keys(key, 6), 3))

    def port(max_batch):
        eng = ServingEngine(ta, tsched.build("flow_sde", 0.7), None,
                            num_steps=3, device="cpu", max_batch=max_batch,
                            cond_len=COND_LEN)
        return eng, eng.rollout(tp, to_torch(cond), 0, x_init=x_init,
                                eps=eps)

    eng, got = port(4)
    assert eng.stats["dispatches"] == je.stats["dispatches"] == {
        "b4/s3": 1, "b2/s3": 1}
    # f32 through three velocity evaluations of two blocks: 1e-5 (measured
    # 7.6e-6 on |x| up to 7.4); a logp sums 1024 terms of order 2 in
    # another order, rtol 1e-5 (measured 4.5e-7)
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.logps.numpy(), np.asarray(want.logps),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.cond.numpy(), np.asarray(want.cond))
    eng1, one = port(8)
    assert eng1.stats["dispatches"] == {"b8/s3": 1}
    np.testing.assert_allclose(one.xs.numpy(), got.xs.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(one.logps.numpy(), got.logps.numpy(),
                               rtol=1e-5)


def _engine_step_draws(jtr, key, it, B):
    """Every draw of one engine-attached ``step`` along the reference's
    key path: the engine's per-request draws of ``request_keys(k_s, B)``
    and the update's."""
    k_s, _ = jax.random.split(jax.random.fold_in(key, it))
    x_init, eps = _jax_draws(jtr.adapter, request_keys(k_s, B),
                             jtr.flow.num_steps)
    t_u, eps_u = _update_draws(jtr, key, it, B)
    return dict(x_init=to_torch(x_init), eps=to_torch(eps),
                update_t=to_torch(t_u), update_eps=to_torch(eps_u))


@pytest.mark.parametrize("name", ["flow_grpo", "awm"])
def test_engine_attached_step_matches_jax(name):
    """Two ``step``s of ``flow_grpo`` and ``awm`` (its ODE rollout through
    ``step_with_eps`` under an all-True mask, as the reference's engine
    runs it) with an engine attached in both packages, 2 prompts x group 3
    through ``max_batch=4`` (chunks of 4 + 2), on the reference's draws,
    held to the band of the engine-free trainer parity tests."""
    jtr, ttr = _trainer_pair(name, G=3)
    je = JServingEngine.for_trainer(jtr, max_batch=4, cond_len=COND_LEN)
    te = ServingEngine.for_trainer(ttr, max_batch=4, cond_len=COND_LEN)
    jtr.attach_engine(je)
    ttr.attach_engine(te)
    _replay_two_steps(name, jtr, ttr, COND_LEN, _engine_step_draws)
    assert te.stats["dispatches"] == je.stats["dispatches"] == {
        "b4/s3": 2, "b2/s3": 2}


def _run_step(name, engine_batch, draws):
    tr = _trainer(name, group_size=2)
    if engine_batch:
        tr.attach_engine(ServingEngine.for_trainer(tr, max_batch=engine_batch,
                                                   cond_len=4))
    m = tr.step(torch.from_numpy(COND[:2]), SEED, it=0, **draws)
    return ({k: float(v) for k, v in m.items()},
            [p.clone() for _, p in tparams.leaves(tr.state.params)])


@pytest.mark.parametrize("name", ["flow_grpo", "mix_grpo", "awm"])
def test_engine_path_in_one_chunk_is_the_engine_free_path(name):
    """2 prompts x group 2 in one chunk (``max_batch=4``) on injected
    draws: the engine-attached step is bitwise the engine-free step for
    the SDE rollouts (the same integrator on the same rows).  AWM's engine
    path steps its ODE through ``step_with_eps`` (the reference's engine
    path) where the engine-free one takes ``step_ode``: the latents then
    differ by the f32 rounding of the step size, and the step is held to
    1e-5 of each metric and to lr / 10 on the params."""
    rng = np.random.default_rng(5)
    draws = {"x_init": torch.from_numpy(rng.standard_normal(
                 (4, 8, 8)).astype(np.float32)),
             "eps": torch.from_numpy(rng.standard_normal(
                 (3, 4, 8, 8)).astype(np.float32))}
    if name == "awm":
        draws["update_t"] = torch.from_numpy(
            rng.uniform(0.02, 0.98, 4).astype(np.float32))
        draws["update_eps"] = torch.from_numpy(rng.standard_normal(
            (4, 8, 8)).astype(np.float32))
    m_free, p_free = _run_step(name, 0, draws)
    m_eng, p_eng = _run_step(name, 4, draws)
    if name == "awm":
        for k, v in m_free.items():
            np.testing.assert_allclose(m_eng[k], v, atol=1e-5, rtol=1e-5,
                                       err_msg=k)
        for a, b in zip(p_eng, p_free):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-4)
        return
    assert m_eng == m_free
    assert all(torch.equal(a, b) for a, b in zip(p_eng, p_free))


def test_engine_attached_runs_replay_bitwise():
    """The engine rollout's seeds derive from (seed, it) alone, so two
    runs of two steps (a resumed run included) are bitwise."""
    runs = []
    for _ in range(2):
        tr = _trainer(group_size=2)
        tr.attach_engine(ServingEngine.for_trainer(tr, max_batch=2,
                                                   cond_len=4))
        runs.append([{k: float(v) for k, v in tr.step(
            torch.from_numpy(COND[:2]), SEED, it=it).items()}
            for it in range(2)])
    assert runs[0] == runs[1]


# -------------------------------------------------------------- describe()
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", sorted(tregistry.names("arch")))
def test_describe_arch_equals_the_reference(arch, reduced):
    """``describe()["arch"]`` (name, family and the analytic
    ``n_params``, which both train CLIs print) equals the reference's for
    every arch the port registers."""
    want = JExperiment(JRunConfig(arch=arch, reduced=reduced)).describe()
    got = TExperiment(TRunConfig(arch=arch, reduced=reduced),
                      device="cpu").describe()
    assert got["arch"] == want["arch"]
    a, b = tconfigs.get(arch), jregistry.build("arch", arch)
    assert (a.n_active_params(), a.attn_free) == (b.n_active_params(),
                                                  b.attn_free)
    if arch == "flux_dit" and not reduced:
        assert got["arch"]["n_params"] == 5_939_371_008


# --------------------------------------------------------- fuzz harness
#
# A deterministic seeded fuzzer over submit/poll/fetch/drain interleavings
# against one warmed engine (module-scoped, like a long-lived process).
# Invariants after every op and at episode end: bounded queues; no
# starvation (polling clears every expired request in a bounded number of
# calls); per-request results equal a direct keyed rollout (the f32 band
# of another batch size); every dispatched shape was warmed.
FUZZ_SEEDS = int(os.environ.get("REPRO_FUZZ_SEEDS", "25"))
FUZZ_TENANTS = ("acme", "heavy", "solo")
FUZZ_CLASSES = ("interactive", "standard", "batch", None)


@pytest.fixture(scope="module")
def fuzz_env():
    clk = _Clock()
    eng = _engine(
        step_tiers=(2, 3), deadline_s=0.5, max_inflight=2, clock=clk,
        admission=_admission(tenant_weights=(("heavy", 3),)))
    eng.warmup()
    direct = {s: functools.partial(_direct, steps=s) for s in (2, 3)}
    return eng, clk, direct


def _check_invariants(eng):
    snap = eng.admission.snapshot()
    for name, row in snap.items():
        assert row["depth"] <= row["limit"], \
            f"queue bound violated for {name}: {row}"
    assert eng.pending() == sum(r["depth"] for r in snap.values())


def _fuzz_episode(eng, clk, direct, seed):
    rng = random.Random(seed)
    live = []                                 # (handle, cond_idx, steps)
    rejections = 0
    for _ in range(rng.randint(6, 14)):
        op = rng.random()
        if op < 0.62:
            i = rng.randrange(7)
            steps = rng.choice((2, 3, None))
            try:
                h = eng.submit(
                    cond=COND[i], seed=rng.randrange(1 << 30),
                    num_steps=steps, tenant=rng.choice(FUZZ_TENANTS),
                    priority=rng.choice(FUZZ_CLASSES),
                    slo_s=rng.choice((None, 0.2, 0.8)))
                live.append((h, i, steps or 3))
            except RetryAfter as e:
                rejections += 1
                payload = e.to_json()
                assert payload["error"] == "over_capacity"
                assert payload["depth"] >= payload["limit"]
                assert payload["retry_after_s"] >= 0
        elif op < 0.88:
            clk.t += rng.choice((0.0, 0.1, 0.3, 0.6))
            eng.poll()
            polls = 1
            while any(eng.admission.has_expired(s, clk.t)
                      for s in eng.admission.tiers()):
                assert eng.poll() > 0, "expired request starved"
                polls += 1
                assert polls <= 64, "deadline backlog never drained"
        else:
            done = [h for h, _, _ in live if h.done]
            if done:
                rng.choice(done).result()
        _check_invariants(eng)
    clk.t += 1.0
    eng.drain()
    assert eng.pending() == 0
    assert all(h.done for h, _, _ in live), "request starved to drain"
    for h, _, _ in live:
        h.result()
    assert eng.stats["inflight"] == 0
    for h, i, steps in rng.sample(live, min(3, len(live))):
        _same_request(h.result(), direct[steps](i, h.seed))
    return rejections


@pytest.mark.parametrize("seed", range(FUZZ_SEEDS))
def test_fuzz_serving_interleavings(fuzz_env, seed):
    eng, clk, direct = fuzz_env
    _fuzz_episode(eng, clk, direct, seed)


def test_fuzz_corpus_deadline_flush_races_full_bucket(fuzz_env):
    """Requests already past their deadline when a submit completes the
    bucket: the full-bucket dispatch at submit wins (each request served
    once), and the following poll finds nothing left to flush."""
    eng, clk, direct = fuzz_env
    before = eng.stats["requests"]
    h = [eng.submit(cond=COND[i], seed=1000 + i) for i in range(3)]
    clk.t += 2.0
    h.append(eng.submit(cond=COND[3], seed=1003))
    assert all(x.done for x in h)
    assert eng.poll() == 0 and eng.pending() == 0
    assert eng.stats["requests"] == before + 4
    _same_request(h[0].result(), direct[3](0, h[0].seed))


def test_fuzz_corpus_mixed_priorities_equal_arrival(fuzz_env):
    """One request per class in one clock tick: the deadline flush batches
    them together and every class is served."""
    eng, clk, direct = fuzz_env
    h = [eng.submit(cond=COND[i], seed=2000 + i, priority=p)
         for i, p in enumerate(("interactive", "standard", "batch"))]
    assert not any(x.done for x in h)
    clk.t += 0.31
    eng.poll()
    assert all(x.done for x in h)
    for i, x in enumerate(h):
        _same_request(x.result(), direct[3](i, x.seed))


def test_fuzz_corpus_reject_then_retry(fuzz_env):
    """Fill a class to its bound while the in-flight window is saturated,
    get the structured rejection, flush, and serve the retried submit."""
    eng, clk, direct = fuzz_env
    clk.t += 10.0
    eng.drain()
    blocker = []
    while eng.stats["inflight"] < eng.max_inflight:
        blocker += [eng.submit(cond=COND[i], seed=3000 + i,
                               priority="standard") for i in range(4)]
    queued = [eng.submit(cond=COND[i % 7], seed=3100 + i, priority="batch")
              for i in range(5)]
    with pytest.raises(RetryAfter) as ei:
        eng.submit(cond=COND[0], seed=3200, priority="batch")
    clk.t += ei.value.retry_after_s + 1e-3
    eng.poll()
    retry = eng.submit(cond=COND[0], seed=3200, priority="batch")
    clk.t += 1.0
    eng.poll()
    assert retry.done and all(x.done for x in queued + blocker)
    _same_request(retry.result(), direct[3](0, 3200))


def test_fuzz_load_only_ran_warmed_shapes(fuzz_env):
    """After the whole corpus (definition order): the fuzzed load ran only
    warmed shapes, and the final stats snapshot still serializes."""
    eng, _, _ = fuzz_env
    assert set(eng.stats["dispatches"]) <= set(eng.stats["warmed_shapes"])
    assert json.loads(json.dumps(eng.stats)) == eng.stats

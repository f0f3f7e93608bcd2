"""Parity of the port's ``repro_torch.distributed`` with the JAX package's
``repro.distributed``, and multi-rank runs of the port on gloo, on the CPU.

Against the JAX package: the per-leaf "model" shard dim of every leaf of
three archs, axis resolution (with ``jax.local_device_count`` and the
port's world size set alike), microbatched gradients against
``accumulated_value_and_grad`` on one set of params and one trajectory,
and the refusals' messages.

Multi-rank: ``torch_dist_worker`` runs each scenario on 2 or 4 spawned
processes joined by a gloo group over a ``file://`` store under the
test's ``tmp_path`` (no port, so test workers never collide), with a join
timeout per scenario.  Every layout trains 2 steps against the one-device
run on the same seed and prompts, in the band of the reference's
``tests/test_distributed.py`` (rtol 1e-3, atol 2e-4).  A scenario runs once
per module; its tests read its result.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import distributed as jdist
from repro.config import DistConfig as JDist
from repro.models import params as jparams
from repro.models.flow import FlowAdapter as JFlowAdapter
from repro_torch import configs as tconfigs
from repro_torch import distributed as tdist
from repro_torch import registry as tregistry
from repro_torch.config import DistConfig as TDist
from repro_torch.config import FlowRLConfig as TFlow
from repro_torch.config import OptimConfig as TOptim
from repro_torch.core.rollout import Trajectory as TTrajectory
from repro_torch.models import params as tparams
from repro_torch.models.flow import FlowAdapter as TFlowAdapter

import torch_dist_worker as worker
from test_torch_trainers import _trainer_pair
from test_torch_training import _np_tree
from torch_parity import COND_DIM, COND_LEN, normal, to_torch
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ARCHS = ["flux_dit", "mamba2-370m", "smollm-360m"]


# ------------------------------------------------------- the plan's dims
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_shard_dim_matches_reference(arch, reduced):
    """Every leaf of the flow adapter's spec (backbone, stacked blocks,
    projections) shards the same dim as the reference's at mp 2, 4, 8,
    exactly; the port's constants are the reference's."""
    get_j = jconfigs.get_reduced if reduced else jconfigs.get
    get_t = tconfigs.get_reduced if reduced else tconfigs.get
    from repro.config import FlowRLConfig as JFlow
    jspec = JFlowAdapter(get_j(arch), JFlow(), 512).spec()
    tspec = TFlowAdapter(get_t(arch), TFlow(), 512).spec()
    jleaves = dict(tparams.leaves(jspec))
    tleaves = dict(tparams.leaves(tspec))
    assert set(jleaves) == set(tleaves)
    assert tparams.MODEL_SHARDABLE == jparams.MODEL_SHARDABLE
    sharded = 0
    for mp in (2, 4, 8):
        for path, tp in tleaves.items():
            jp = jleaves[path]
            assert (tp.shape, tp.axes) == (jp.shape, jp.axes)
            want = jparams.model_shard_dim(jp.shape, jp.axes, mp)
            assert tparams.model_shard_dim(tp.shape, tp.axes, mp) == want, \
                (path, mp)
            sharded += want is not None
    assert sharded > 0


# --------------------------------------------------------- axis resolution
def _outcome(fn):
    """The value, or the error's type and message up to its hint (the
    reference's hint names XLA_FLAGS, the port's torchrun)."""
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e).split(" — ")[0])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_resolve_axes_matches_reference(n, monkeypatch):
    """``resolve_axes`` over a grid of (dp, mp), 0 ("the rest") and the
    error cases included, with ``jax.local_device_count`` and the port's
    world size both n: the same axes, or the same error message."""
    monkeypatch.setattr(jax, "local_device_count", lambda: n)
    monkeypatch.setattr(tdist.mesh, "world_size", lambda: n)
    vals = (-1, 0, 1, 2, 3, 4, 8, 9)
    for dp in vals:
        for mp in vals:
            want = _outcome(lambda: jdist.resolve_axes(
                JDist(data_parallel=dp, model_parallel=mp)))
            got = _outcome(lambda: tdist.resolve_axes(
                TDist(data_parallel=dp, model_parallel=mp)))
            assert got == want, (n, dp, mp)


def test_single_device_resolves_to_no_mesh():
    """``dp x mp = 1`` is the exact single-device path: no mesh, no plan;
    a layout larger than the (absent) group is refused as the reference
    refuses it."""
    assert tdist.train_mesh(TDist(), "cpu") is None
    assert tdist.train_mesh(TDist(data_parallel=0, model_parallel=0),
                            "cpu") is None
    assert tdist.mesh_dp(None) == 1 and tdist.mesh_mp(None) == 1
    assert tdist.partition_plan(None, {}) is None
    with pytest.raises(ValueError, match="model_parallel=2 but only 1 "
                       "device"):
        tdist.train_mesh(TDist(model_parallel=2), "cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tdist.train_mesh(TDist(data_parallel=2), "cpu")


# ------------------------------------------------------------ refusals
class _StubMesh:
    """A data axis of ``dp`` for the batch checks, in both packages'
    spellings (the reference reads ``mesh.shape``, the port
    ``mesh.size``)."""

    def __init__(self, dp):
        self.shape = {"data": dp}
        self._dp = dp

    def size(self, dim):
        return (self._dp, 1)[dim]


@pytest.mark.parametrize("batch,dp,microbatch", [
    (8, 1, 3), (8, 2, 0), (8, 3, 0), (8, 2, 2), (8, 4, 4), (12, 4, 2),
    (8, 4, 3)])
def test_batch_divisibility_matches_reference(batch, dp, microbatch):
    """``check_batch_divisible``: the same refusals with the same text."""
    got = _outcome(lambda: tdist.check_batch_divisible(
        batch, _StubMesh(dp), microbatch))
    want = _outcome(lambda: jdist.check_batch_divisible(
        batch, _StubMesh(dp), microbatch))
    assert got == want


def _tiny(tname="flow_grpo", dist=None):
    flow = TFlow(num_steps=2, group_size=4, latent_tokens=8, latent_dim=8)
    return tregistry.build("trainer", tname, worker.arch(), flow,
                           TOptim(), device="cpu", cond_dim=32,
                           dtype=torch.float32, dist=dist)


def test_microbatch_refusals_match_reference():
    """The reference's order and text: a negative count at construction,
    GRPO-Guard's batch-global RatioNorm with microbatch > 1 at
    construction, a count that does not divide the batch at the step."""
    with pytest.raises(ValueError, match="dist.microbatch must be >= 0"):
        _tiny(dist=TDist(microbatch=-1))
    with pytest.raises(ValueError) as e:
        _tiny("grpo_guard", TDist(microbatch=2))
    assert str(e.value) == (
        "GRPOGuardTrainer computes batch-global loss statistics and cannot "
        "be microbatched: chunked gradient accumulation would make them "
        "chunk-local and change the training math — set dist.microbatch=0")
    _tiny("grpo_guard", TDist(microbatch=1))
    tr = _tiny(dist=TDist(microbatch=3))
    with pytest.raises(ValueError, match=r"8.*microbatch.*3"):
        tr.step(torch.zeros((2, 4, 32)), 0)
    # donate_state is accepted either way (the update is in place)
    _tiny(dist=TDist(donate_state=False)).step(torch.zeros((2, 4, 32)), 0)


# --------------------------------------------------------- microbatching
def _grpo_case():
    """A JAX and a port flow_grpo trainer on one tree of params, one JAX
    trajectory carried across and its advantages."""
    jtr, ttr = _trainer_pair("flow_grpo", G=4)
    (cond,) = normal(21, (2, COND_LEN, COND_DIM))
    key = jax.random.PRNGKey(22)
    jt = jtr.sample(jtr.state.params, jnp.asarray(cond), key)
    _, adv, _ = jtr._rewards_jit(jt.x0, {"cond": jt.cond})
    tt = TTrajectory(to_torch(jt.xs), to_torch(jt.logps),
                     torch.from_numpy(np.asarray(jt.ts)),
                     torch.from_numpy(np.asarray(jt.sde_mask)),
                     to_torch(jt.cond))
    return jtr, ttr, jt, tt, adv, key


def _port_grads(ttr, tt, adv, k):
    ttr.dist = TDist(microbatch=k)
    loss, _ = ttr.backward(tt, to_torch(adv), None)
    grads = {path: p.grad.numpy().copy()
             for path, p in tparams.leaves(ttr.state.params)}
    for _, p in tparams.leaves(ttr.state.params):
        p.grad = None
    return float(loss), grads


def test_microbatch_grads_match_jax_accumulation():
    """The port's k = 2 accumulation (two chunks' backwards, f32 sums / 2)
    against ``repro.distributed.accumulated_value_and_grad`` on the same
    params, trajectory and advantages.  The loss is a residue ~ -mean(A)
    whose ratio sits at the f32 rounding of two log-densities: 1e-4, the
    trainers' parity band.  Each leaf's gradient within 5e-4 of its max
    |grad|: the port's full-batch gradient is 2.5e-4 from JAX's on this
    trajectory (two frameworks' backward orders), and accumulating adds
    nothing to that (2.4e-4 measured)."""
    jtr, ttr, jt, tt, adv, key = _grpo_case()
    (jloss, _), jgrads = jdist.accumulated_value_and_grad(
        jtr.loss_fn, jtr.state.params, jt, adv, key, (), 2)
    tloss, tgrads = _port_grads(ttr, tt, adv, 2)
    np.testing.assert_allclose(tloss, float(jloss), rtol=0, atol=1e-4)
    nonzero = 0
    for path, g_j in tparams.leaves(_np_tree(jgrads)):
        scale = float(np.abs(g_j).max())
        nonzero += scale > 0
        np.testing.assert_allclose(tgrads[path], g_j, rtol=0,
                                   atol=5e-4 * max(scale, 1e-12),
                                   err_msg=str(path))
    assert nonzero > 10


def test_microbatch_grads_match_full_batch():
    """In the port, k = 2 and 4 against the full batch.  The velocity of a
    chunk of 4 or 2 rows rounds differently from that of 8 on the CPU
    (matmuls sum in another order at another batch size), and the GRPO
    ratio magnifies the log-densities' rounding, so the reference's band
    (loss atol 1e-7) does not hold: its own k = 2 moves this loss by
    1.5e-5.  Stated band: the loss to 5e-5, each leaf's gradient within
    1e-4 of its max |grad| (measured at most 5.8e-5, at k = 4)."""
    _, ttr, _, tt, adv, _ = _grpo_case()
    full_loss, full = _port_grads(ttr, tt, adv, 0)
    for k in (2, 4):
        loss, grads = _port_grads(ttr, tt, adv, k)
        np.testing.assert_allclose(loss, full_loss, rtol=0, atol=5e-5)
        for path, g in full.items():
            scale = max(float(np.abs(g).max()), 1e-12)
            np.testing.assert_allclose(grads[path], g, rtol=0,
                                       atol=1e-4 * scale,
                                       err_msg=f"k={k} {path}")


def test_chunk_batch_matches_reference():
    (x,) = normal(31, (4, 8, 6))
    for axis in (0, 1, 2):
        got = tdist.chunk_batch(to_torch(x), axis, 2).numpy()
        want = np.asarray(jdist.chunk_batch(jnp.asarray(x), axis, 2))
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ multi-rank
@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return worker.spawn(2, "two_ranks", tmp_path_factory.mktemp("two"), 240)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return worker.spawn(4, "four_ranks", tmp_path_factory.mktemp("four"),
                        240)


def _close(h_ref, h, params_ref, params, what):
    """The reference's band: metrics within 2e-4 + 1e-3 |ref|, every param
    within rtol 1e-3, atol 2e-4."""
    assert len(h_ref) == len(h) == 2
    for a, b in zip(h_ref, h):
        for k in worker.METRICS:
            assert abs(a[k] - b[k]) <= 2e-4 + 1e-3 * abs(a[k]), \
                (what, k, a[k], b[k])
    assert set(params_ref) == set(params)
    for k, x in params_ref.items():
        np.testing.assert_allclose(params[k], x, rtol=1e-3, atol=2e-4,
                                   err_msg=f"{what} {k}")


LAYOUTS = [(t, lay) for t in ("flow_grpo", "grpo_guard", "nft", "awm")
           for lay in ("dp2", "mp2", "dp2_mb2")
           if not (t == "grpo_guard" and lay == "dp2_mb2")]


@pytest.mark.parametrize("tname,layout", LAYOUTS)
def test_two_rank_training_matches_single_device(two_ranks, tname, layout):
    """dp = 2, mp = 2 and dp = 2 + microbatch 2 on two gloo ranks, 2 steps,
    against one device.  ``flow_grpo``'s loss draws nothing, so its
    microbatched run is held against the full-batch one; NFT/AWM draw per
    chunk, so theirs is held against the one-device run with the same two
    chunks."""
    h, params = two_ranks[f"{tname}/{layout}"]
    ref = ("single_mb2" if layout == "dp2_mb2" and tname in ("nft", "awm")
           else "single")
    h_ref, params_ref = two_ranks[f"{tname}/{ref}"]
    _close(h_ref, h, params_ref, params, f"{tname} {layout}")
    if layout == "mp2":
        rep = two_ranks[f"{tname}/mp2/bytes"]
        assert rep["sharded_leaves"] > 0
        assert rep["per_device_bytes"] < 0.55 * rep["total_bytes"]


@pytest.mark.parametrize("tname", ["flow_grpo", "grpo_guard", "nft", "awm"])
def test_two_axis_training_matches_single_device(four_ranks, tname):
    """dp = 2 x mp = 2 on four gloo ranks, params and moments sharded over
    "model", 2 steps against one device."""
    h_ref, h, params_ref, params, rep = four_ranks[tname]
    _close(h_ref, h, params_ref, params, f"{tname} dp2xmp2")
    assert rep["sharded_leaves"] > 0
    assert rep["per_device_bytes"] < 0.55 * rep["total_bytes"]


def test_checkpoint_moves_between_layouts_bitwise(four_ranks):
    """A dp = 2 x mp = 2 checkpoint (the canonical layout, written by rank
    0) restores bitwise at dp = 1 and at mp = 4 (each rank's shards are the
    saved leaves' slices, and gather back to them), and training goes on
    from it."""
    res = four_ranks["ckpt"]
    assert res["dp1"] == (2, True)
    step, shards_equal, gathered_equal, rep = res["mp4"]
    assert (step, shards_equal, gathered_equal) == (2, True, True)
    assert rep["per_device_bytes"] < 0.3 * rep["total_bytes"]
    assert np.isfinite(res["mp4_continues"])


def test_sharded_serving_is_per_request_bitwise(two_ranks):
    """The dp = 2 engine (dp-aligned buckets, each rank half a bucket,
    latents gathered) and the mp = 2 engine (params sharded, each layer
    gathered whole) serve every request bitwise what the one-device engine
    serves it."""
    res = two_ranks["serve"]
    np.testing.assert_array_equal(res["dp2"], res["dp1"])
    np.testing.assert_array_equal(res["mp2"], res["dp1"])
    assert res["mp2/stats"]["model_parallel"] == 2
    assert res["dp2/stats"]["data_parallel"] == 2
    assert all(b % 2 == 0 for b in res["dp2/stats"]["buckets"])
    assert res["dp1/stats"]["data_parallel"] == 1


def test_engine_attached_training_at_dp2_matches_one_device(two_ranks):
    """flow_grpo through an attached engine whose ``max_batch`` (4) is
    below the batch (2 prompts x 4), at dp = 2 and at mp = 2 against dp =
    1, 2 steps, in the reference's band.  The engine's dp-aligned buckets run each chunk
    half on each rank and gather it; each rank then hands the update its
    own rows of the trajectory: the one-device engine's rows, to f32
    rounding (a chunk's rows roll out in a batch of 2 on a rank and of 4
    on one device; the band of ``tests/test_torch_serving.py``)."""
    res = two_ranks["engine"]
    h_ref, p_ref = res["dp1"]
    for layout in ("dp2", "mp2"):
        h, p = res[layout]
        _close(h_ref, h, p_ref, p, f"flow_grpo engine {layout}")
    # mp = 2: the trainer's shards, each layer gathered whole, roll out the
    # one-device engine's trajectory to f32 rounding
    assert res["mp2/xs_gap"] <= 1e-5
    assert res["mp2/stats"]["dispatches"] == {"b4/s3": 6}
    # one sample and two steps, each 8 rows in two chunks of 4
    assert res["dp1/stats"]["dispatches"] == {"b4/s3": 6}
    assert res["dp2/stats"]["dispatches"] == {"b4/s3": 6}
    assert res["dp2/stats"]["buckets"] == [2, 4]
    assert res["dp2/stats"]["data_parallel"] == 2
    assert res["dp2/stats"]["padded_lanes"] == 0
    (rows0, gaps0), (rows1, gaps1) = res["own_rows"]
    assert (rows0, rows1) == ([0, 1, 2, 3], [4, 5, 6, 7])
    for xs_gap, logps_gap, cond_equal in (gaps0, gaps1):
        assert xs_gap <= 1e-5 and logps_gap <= 1e-5 and cond_equal


def test_straddling_groups_use_full_batch_statistics(two_ranks):
    """3 prompts x groups of 4 on two data ranks of 6 rows each, so the
    second prompt's group is split 2 + 2 between them, with a groupwise
    reward (``pref_group``) and ``gdpo`` advantages: reward, loss and grad
    norm are the one-device run's."""
    h_ref, h, rows = two_ranks["straddle"]
    assert rows == [0, 1, 2, 3, 4, 5]
    for k in worker.METRICS:
        assert abs(h_ref[0][k] - h[0][k]) <= 2e-4 + 1e-3 * abs(h_ref[0][k])


def test_sharded_global_norm_equals_unsharded(two_ranks):
    """The global norm of a tree sharded over "model" (the shards' squares
    all-reduced, the replicated leaves counted once) equals the canonical
    tree's, to f32 summation order."""
    got, want, n_sharded = two_ranks["norm"]
    assert n_sharded > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_rollout_sharded_rolls_each_rank_from_its_fold(two_ranks):
    """The generation entry point: each data rank rolls out its rows from
    ``fold_seed(seed, rank)`` and the trajectory is gathered whole."""
    shape, same, cond_equal = two_ranks["rollout_sharded"]
    assert shape[1] == 8 and same == [True, True] and cond_equal


class _PlanMesh:
    """A (2, 2) mesh seen from the rank at (0, 1), for the plan's local
    bookkeeping (no collective runs)."""

    def size(self, dim):
        return 2

    def get_coordinate(self):
        return [0, 1]


def test_partition_plan_layouts_and_bytes():
    """The plan over a (2, 2) mesh: each leaf's dim is the reference's,
    its placements (replicated over "data", ``Shard(dim)`` over "model"),
    the AdamW moments inherit their param's dim and the step counter is
    replicated, a canonical state shards to this rank's halves (model rank
    1: the second half), and the byte report halves the sharded leaves."""
    from torch.distributed.tensor import Replicate, Shard
    tr = _tiny()
    plan = tdist.PartitionPlan(_PlanMesh(), tr.adapter.spec())
    assert plan.model_parallel == 2 and plan.data_parallel == 2
    dims = dict(tparams.leaves(plan.param_specs()))
    spec = dict(tparams.leaves(tr.adapter.spec()))
    assert dims == {k: jparams.model_shard_dim(p.shape, p.axes, 2)
                    for k, p in spec.items()}
    for k, pl in tparams.leaves(plan.param_shardings()):
        assert pl == ((Replicate(), Replicate()) if dims[k] is None
                      else (Replicate(), Shard(dims[k])))
    assert tdist.replicated(None) == (Replicate(), Replicate())
    assert tdist.batch_sharding(None, 1) == (Shard(1), Replicate())
    st = plan.state_shardings(tr.state)
    assert dict(tparams.leaves(st.params)) == dims
    assert dict(tparams.leaves(st.opt.mu)) == dims
    assert st.opt.step is None
    local = plan.shard_state(tr.state)
    for k, t in tparams.leaves(local.params):
        full = dict(tparams.leaves(tr.state.params))[k]
        d = dims[k]
        if d is None:
            assert t is full
        else:
            n = full.shape[d] // 2
            assert torch.equal(t, full.narrow(d, n, n))
    assert plan.state_shardings(local) == st
    canon, mine = plan.bytes_report(tr.state), plan.bytes_report(local)
    assert canon == mine
    assert 0 < mine["sharded_leaves"]
    assert mine["per_device_bytes"] < 0.55 * mine["total_bytes"]

"""``repro_torch.perf`` against the contracts of ``tests/test_perf.py`` that
need no mesh, and against the JAX package's ``repro.perf`` on the same
inputs and draws, on the CPU at reduced size.

Exactness classes held here (``repro_torch/perf/__init__.py``):

* ``remat="scan"`` is bitwise ``"none"`` (the same program in the port).
* ``remat="block"`` is within the reference's band of ``"none"``: loss
  rtol 1e-5 / atol 1e-6, bf16 params ``BF16_ATOL`` (it is bitwise on the
  CPU, where a block's forward reruns the same ops); its loss is within
  the trainer parity band (atol = rtol = 1e-4) of the JAX package's
  ``PerfConfig(remat="block")`` loss on the reference's draws.
* ``policy_dtype="bfloat16"`` on bf16 params is bitwise the default;
  ``"float32"`` differs from it and matches the JAX package's f32-policy
  velocity within 1e-4 of max |v|.
* ``fuse_step`` matches the unfused step within the reference's
  tolerances (params rtol 1e-5 / atol 1e-6, loss 1e-5); on the CPU it runs
  the unfused step's body, and is bitwise.
* ``offload_rewards`` gives the resident path's rewards, losses and
  params, bitwise; ``remat_offload`` is bitwise ``"none"``, as ``scan``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import registry as jregistry
from repro.config import FlowRLConfig as JFlow
from repro.config import OptimConfig as JOptim
from repro.config import PerfConfig as JPerf
from repro.config import RewardSpec as JSpec
from repro.core.trainers import RLState as JRLState
from repro.models.flow import FlowAdapter as JFlowAdapter
from repro.perf import policy as jpolicy
from repro_torch import configs as tconfigs
from repro_torch import perf as tperf
from repro_torch import registry as tregistry
from repro_torch.config import FlowRLConfig as TFlow
from repro_torch.config import OptimConfig as TOptim
from repro_torch.config import PerfConfig as TPerf
from repro_torch.config import RewardSpec as TSpec
from repro_torch.launch import train as ttrain
from repro_torch.models import params as tparams
from repro_torch.models.flow import FlowAdapter as TFlowAdapter

from test_torch_trainers import _step_draws
from test_torch_training import (REWARDS, TINY_ENCODER, _carry_store,
                                 _np_tree, _specs)
from torch_parity import (COND_DIM, COND_LEN, LATENT_DIM, LATENT_TOKENS,
                          _randomize_ada, normal, params_pair, to_torch)
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = tconfigs.get_reduced("flux_dit")
FLOW = TFlow(num_steps=4, group_size=4, latent_tokens=8, latent_dim=8,
             clip_range=0.2,
             rewards=(TSpec("text_render", 1.0,
                            args={"latent_dim": 8, "latent_tokens": 8}),
                      TSpec("pickscore", 0.25, args={"latent_dim": 8})))
OPT = TOptim(lr=1e-3, total_steps=50, warmup_steps=2)
COND = torch.randn(2, 4, 512, generator=torch.Generator().manual_seed(7))

# the reference's bf16 band: one ulp at |w|~0.25 is ~2e-3, and AdamW's
# rsqrt amplifies single-ulp gradient noise to a few ulps
BF16_ATOL = 0.02


def make(name="flow_grpo", dtype=torch.bfloat16, **perf):
    return tregistry.build("trainer", name, ARCH, FLOW, OPT, device="cpu",
                           dtype=dtype, perf=TPerf(**perf))


def run_steps(tr, n=2):
    return [tr.step(COND, 0, it=it) for it in range(n)]


def bits(tree):
    return [p.view(torch.int16) if p.dtype == torch.bfloat16 else p
            for _, p in tparams.leaves(tree)]


def params_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(bits(a.state.params),
                                                 bits(b.state.params)))


def params_close(a, b, rtol=1e-5, atol=1e-6):
    for (_, x), (_, y) in zip(tparams.leaves(a.state.params),
                              tparams.leaves(b.state.params)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(),
                                   rtol=rtol, atol=atol)


# ------------------------------------------------------------- validation
@pytest.mark.parametrize("bad, match", [
    ({"remat": "blocks"}, "perf.remat"),
    ({"policy_dtype": "fp8"}, "policy_dtype"),
    ({"remat": "block", "remat_offload": True}, "remat_offload")])
def test_validate_raises_the_references_errors(bad, match):
    """The three refusals of ``repro.perf.policy.validate``, with its
    messages, from ``validate`` and from trainer construction."""
    with pytest.raises(ValueError, match=match) as got:
        tperf.validate(TPerf(**bad))
    with pytest.raises(ValueError) as want:
        jpolicy.validate(JPerf(**bad))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=match):
        make(**bad)
    assert tperf.REMAT_MODES == jpolicy.REMAT_MODES
    assert sorted(tperf.POLICY_DTYPES) == sorted(jpolicy.POLICY_DTYPES)


# ------------------------------------------------------------------ remat
@pytest.mark.parametrize("name", ["flow_grpo", "mix_grpo"])
def test_remat_scan_bitwise_equals_none(name):
    """Three steps under ``remat="scan"`` leave bitwise the params and
    metrics of ``"none"``: the port's loss already holds one timestep's
    activations at a time, so scan is the same program."""
    base, scan = make(name), make(name, remat="scan")
    mb, ms = run_steps(base, 3), run_steps(scan, 3)
    assert params_equal(base, scan)
    for a, b in zip(mb, ms):
        assert set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_remat_block_within_the_references_band_of_none():
    base, blk = make(), make(remat="block")
    traj = base.sample(base.state.params, COND, torch.Generator(
        ).manual_seed(0))
    _, adv, _ = base._rewards(traj.x0, {"cond": traj.cond})
    lb, _ = base.backward(traj, adv)
    lk, _ = blk.backward(traj, adv)
    # loss: the reference's rtol 1e-5 / atol 1e-6
    np.testing.assert_allclose(float(lk), float(lb), rtol=1e-5, atol=1e-6)
    for tr in (base, blk):
        for _, p in tparams.leaves(tr.state.params):
            p.grad = None
    run_steps(base), run_steps(blk)
    params_close(base, blk, rtol=BF16_ATOL, atol=BF16_ATOL)


def _perf_pair(name, jperf, tperf_, T=3, G=2, seed=0):
    """A JAX and a port trainer ``name`` over the reduced flux_dit in f32
    under the given perf policies, on one parameter tree (modulation
    drawn) and one set of reward towers (``_trainer_pair``'s set-up)."""
    kw = dict(num_steps=T, group_size=G, clip_range=0.2,
              latent_tokens=LATENT_TOKENS, latent_dim=LATENT_DIM,
              advantage_agg="gdpo")
    jtr = jregistry.build("trainer", name, jconfigs.get_reduced("flux_dit"),
                          JFlow(**kw, rewards=_specs(REWARDS, JSpec)),
                          JOptim(lr=1e-3, total_steps=10, warmup_steps=2),
                          key=jax.random.PRNGKey(seed), cond_dim=COND_DIM,
                          dtype=jnp.float32, perf=jperf)
    tree = _randomize_ada(_np_tree(jtr.state.params),
                          np.random.default_rng(seed + 100))
    jp = jax.tree.map(jnp.asarray, tree)
    jtr.state = JRLState(jp, jtr.optimizer.init(jp))
    ttr = tregistry.build("trainer", name, ARCH,
                          TFlow(**kw, rewards=_specs(REWARDS, TSpec)),
                          TOptim(lr=1e-3, total_steps=10, warmup_steps=2),
                          device="cpu", cond_dim=COND_DIM,
                          dtype=torch.float32, perf=tperf_,
                          params=tparams.from_numpy(tree, "cpu"))
    ttr.loader.bind(_carry_store(jtr.loader.param_store()))
    return jtr, ttr


@pytest.mark.parametrize("name", ["flow_grpo", "nft"])
def test_remat_block_step_matches_the_jax_block_step(name):
    """One full step under ``remat="block"`` in both packages, on the
    reference's draws: the loss, grad norm and reward within the trainer
    parity band (``test_torch_trainers._replay_two_steps``)."""
    jtr, ttr = _perf_pair(name, JPerf(remat="block"), TPerf(remat="block"))
    (cond,) = normal(8, (2, COND_LEN, COND_DIM))
    key = jax.random.PRNGKey(4)
    draws = _step_draws(jtr, key, 0, 2 * jtr.flow.group_size)
    jm = jax.device_get(jtr.step(jnp.asarray(cond), key, it=0))
    tm = ttr.step(to_torch(cond), 0, it=0, **draws)
    np.testing.assert_allclose(float(tm["reward_mean"]),
                               float(jm["reward_mean"]), atol=1e-4)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)


def test_saved_bytes_block_below_none_and_scan_equal():
    """``memory_stats``' saved-for-backward bytes (the counterpart of the
    reference's temp-bytes regression): ``block`` keeps only each block's
    input, below ``none``; ``scan`` is ``none`` to the byte."""
    mem = {mode: make(remat=mode).memory_stats(COND)["update"]
           for mode in ("none", "scan", "block")}
    peak = {mode: m["saved_peak_bytes"] for mode, m in mem.items()}
    assert peak["scan"] == peak["none"], peak
    assert 0 < peak["block"] < peak["none"], peak
    assert mem["scan"] == mem["none"]


# ------------------------------------------------------------ dtype policy
def test_policy_dtype_explicit_bf16_bitwise_equals_default():
    base, bf16 = make(), make(policy_dtype="bfloat16")
    mb, mf = run_steps(base), run_steps(bf16)
    assert params_equal(base, bf16)
    assert torch.equal(mb[-1]["loss"], mf[-1]["loss"])


def test_policy_dtype_f32_on_bf16_params_matches_jax():
    """f32 activations on bf16 parameters: the port's velocity differs from
    its bf16 default and matches the JAX package's ``policy_dtype=
    "float32"`` velocity within 1e-4 of max |v| (f32 sums in another
    order); a step under the policy is finite."""
    jflow = JFlow(num_steps=2, latent_tokens=LATENT_TOKENS,
                  latent_dim=LATENT_DIM)
    tflow = TFlow(num_steps=2, latent_tokens=LATENT_TOKENS,
                  latent_dim=LATENT_DIM)
    ja = JFlowAdapter(jconfigs.get_reduced("flux_dit"), jflow, COND_DIM,
                      policy_dtype=jnp.float32)
    jp, tp = params_pair(ja, jnp.bfloat16)
    ta32 = TFlowAdapter(ARCH, tflow, COND_DIM, policy_dtype=torch.float32)
    ta = TFlowAdapter(ARCH, tflow, COND_DIM)
    x, cond = normal(5, (2, LATENT_TOKENS, LATENT_DIM), (2, COND_LEN,
                                                         COND_DIM))
    t = np.array([0.3, 0.8], np.float32)
    want = np.asarray(ja.velocity(jp, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(cond)))
    got = ta32.velocity(tp, to_torch(x), to_torch(t), to_torch(cond))
    v_bf16 = ta.velocity(tp, to_torch(x), to_torch(t), to_torch(cond))
    assert got.dtype == v_bf16.dtype == torch.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale)
    assert not torch.equal(got, v_bf16)
    m = run_steps(make(policy_dtype="float32"), 1)[0]
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


# ------------------------------------------------------------- fused step
@pytest.mark.parametrize("name", ["flow_grpo", "nft", "awm"])
def test_fused_step_matches_unfused(name):
    base, fused = make(name), make(name, fuse_step=True)
    assert fused._fused is not None and base._fused is None
    mb, mf = run_steps(base), run_steps(fused)
    # the reference's tolerances (f32-rounding-equal there)
    params_close(base, fused)
    np.testing.assert_allclose(float(mf[-1]["reward_mean"]),
                               float(mb[-1]["reward_mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(mf[-1]["loss"]), float(mb[-1]["loss"]),
                               rtol=1e-5, atol=1e-5)
    # on the CPU the fused step is the unfused step's body: bitwise
    assert params_equal(base, fused)
    assert int(fused.state.opt.step) == 2


def test_step_metrics_are_device_scalars():
    """Both step paths return 0-d tensors on the trainer's device, the
    weighted ``reward_mean`` and the per-reward means included."""
    for tr in (make(), make(fuse_step=True)):
        m = tr.step(COND, 0, it=0)
        assert {"reward_mean", "reward/text_render:0", "loss",
                "grad_norm", "lr"} <= set(m)
        assert all(isinstance(v, torch.Tensor) and v.dim() == 0
                   and v.device == tr.device for v in m.values()), m
        w = tr.loader.weight_map()
        want = sum(w[k] * float(m[f"reward/{k}"]) for k in w)
        np.testing.assert_allclose(float(m["reward_mean"]), want,
                                   rtol=1e-6)


# ---------------------------------------------------------------- offload
def test_offload_rewards_equals_resident_and_reports_tower_bytes():
    base, off = make(), make(offload_rewards=True)
    assert off.offloads_rewards and not base.offloads_rewards
    mb, mo = run_steps(base), run_steps(off)
    assert params_equal(base, off)
    for a, b in zip(mb, mo):
        for k in ("reward_mean", "reward/text_render:0",
                  "reward/pickscore:1", "loss"):
            assert torch.equal(a[k], b[k]), k
    # text_render's projection (cond_dim, Lt * ld) and pickscore's MLP,
    # f32: the bytes from the shapes
    d_in = 8 + 512
    want = 4 * (512 * 8 * 8 + d_in * 256 + 256 * 256 + 256)
    rep = tperf.reward_tower_report(off)
    assert rep == {"tower_bytes": want, "device_resident_bytes": 0,
                   "device_bytes_freed": want, "offloaded": True}
    assert tperf.reward_tower_report(base)["device_resident_bytes"] == want
    # the loop's prefetch and the step's own copy give the same rewards
    off.prefetch_reward_params()
    assert off._reward_prefetch is not None
    m = off.step(COND, 0, it=5)
    assert off._reward_prefetch is None and torch.isfinite(m["loss"])


def test_remat_offload_equals_none():
    """The trainer under ``remat="scan"`` + ``remat_offload`` is bitwise
    ``"none"``, metrics and params: with no scan body the port has no
    residual to offload, so the policy is None and the update saves the
    same bytes."""
    base, off = make(), make(remat="scan", remat_offload=True)
    assert tperf.remat_policy(off.perf) is None
    mb, mo = run_steps(base), run_steps(off)
    assert params_equal(base, off)
    for a, b in zip(mb, mo):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert (off.memory_stats(COND)["update"]
            == base.memory_stats(COND)["update"])


def test_launch_counts_move_between_capture_and_replay():
    """``kernels.counts``, which the fused step uses to count a graph's
    kernels at each replay: ``since`` reads what was counted, ``add`` with
    ``times=-1`` takes it back out (a capture), and adding it again once
    per replay leaves the counters at what ran."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.kernels.sde_step import sde_step
    start = counts.read()
    sde_step.launches += 4
    ssd_scan.launches += 2
    ssd_scan.variant_launches["wgmma"] += 2
    captured = counts.since(start)
    assert {k: n for k, n in captured.items() if n} == {
        "sde_step": 4, "ssd_scan": 2, "ssd_scan/wgmma": 2}
    counts.add(captured, times=-1)
    assert counts.read() == start
    for _ in range(3):
        counts.add(captured)
    assert counts.since(start) == {k: 3 * n for k, n in captured.items()}
    counts.add(captured, times=-3)
    assert counts.read() == start


# ---------------------------------------------------------- memory_stats
def test_memory_stats_entries():
    tr = make(fuse_step=True, offload_rewards=True)
    mem = tr.memory_stats(COND)
    assert set(mem) == {"update", "state", "reward_towers", "fused"}
    n = sum(p.numel() for _, p in tparams.leaves(tr.state.params))
    want = n * 2 + 2 * n * 4 + 4          # bf16 params, f32 moments, step
    assert mem["state"] == {"total_bytes": want, "per_device_bytes": want,
                            "sharded_leaves": 0}
    assert mem["fused"] == {"captures": 0, "replays": 0, "graphs": 0,
                            "launches_per_replay": []}
    assert mem["update"]["saved_peak_bytes"] > 0
    # memory_stats runs the update but moves nothing
    assert int(tr.state.opt.step) == 0
    assert all(p.grad is None for _, p in tparams.leaves(tr.state.params))


# ------------------------------------------------------------ front doors
def test_experiment_perf_plumbing(tmp_path):
    from repro_torch.api import Experiment
    exp = Experiment.from_cli([
        "--reduced", "--device", "cpu", "--set", "perf.remat=scan",
        "--set", "perf.fuse_step=true",
        "--set", f"flow.cache_dir={tmp_path}/cache"])
    tr = exp.build_trainer()
    assert tr.perf.remat == "scan" and tr._fused is not None
    # perf is runtime policy, not experiment identity
    assert "perf" not in exp._ckpt_identity()


def test_train_cli_prints_the_perf_lines(tmp_path, capsys):
    res = ttrain.main([
        "--device", "cpu", "--reduced", "--steps", "2",
        "--set", "flow.num_steps=2", "--set", "flow.group_size=2",
        "--set", "data.encoder=" + json.dumps(TINY_ENCODER),
        "--set", f"flow.cache_dir={tmp_path / 'cache'}",
        "--set", f"loop.ckpt_dir={tmp_path / 'ckpt'}",
        "--set", "loop.log_every=0", "--set", "perf.remat=block",
        "--set", "perf.log_memory=true", "--set", "perf.fuse_step=true",
        "--set", "perf.offload_rewards=true", "--set", "loop.pipeline=2"])
    assert [r["step"] for r in res["history"]] == [0, 1]
    out = capsys.readouterr().out
    assert "[perf] loop.pipeline=2" in out
    assert "[perf] remat=block fuse_step=True offload_rewards=true" in out
    for name in ("update", "state", "reward_towers", "fused"):
        assert f"[perf] {name} memory_stats:" in out

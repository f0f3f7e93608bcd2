"""Parity of the port's training slice (``repro_torch`` optim, rewards,
rollout, trainer, preprocessing cache, checkpoints, loop and train CLI)
with the JAX package, on the CPU.

Both packages run on the same numbers: parameters and reward towers are
made by the JAX package and carried across with
``repro_torch.models.params.from_numpy``; the JAX package's random draws
(its init latent and per-step noise) are recomputed as it makes them and
injected into the port.  The kernels run their plain versions here
(``chip_smoke.py`` holds the CUDA kernels against those on the card).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jconfigs
from repro import registry as jregistry
from repro.config import FlowRLConfig as JFlow
from repro.config import OptimConfig as JOptim
from repro.config import RewardSpec as JSpec
from repro.core import schedulers as jsched
from repro.core.preprocess import ConditionProvider as JProvider
from repro.core.preprocess import PreprocessCache as JCache
from repro.core.preprocess import preprocess_dataset as jpreprocess
from repro.core.rewards import MultiRewardLoader as JLoader
from repro.core.rewards import compute_advantages as jadvantages
from repro.core.rollout import rollout as jrollout
from repro.core.trainers import RLState as JRLState
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import clip_by_global_norm as jclip
from repro.optim import make_schedule as jschedule
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tconfigs
from repro_torch import registry as tregistry
from repro_torch.config import FlowRLConfig as TFlow
from repro_torch.config import OptimConfig as TOptim
from repro_torch.config import RewardSpec as TSpec
from repro_torch.core import schedulers as tsched
from repro_torch.core.preprocess import ConditionProvider as TProvider
from repro_torch.core.preprocess import PreprocessCache as TCache
from repro_torch.core.rewards import MultiRewardLoader as TLoader
from repro_torch.core.rewards import compute_advantages as tadvantages
from repro_torch.core.rollout import group_repeat, mix_sde_mask
from repro_torch.core.rollout import rollout as trollout
from repro_torch.core.trainers import RLState as TRLState
from repro_torch.launch import train as ttrain
from repro_torch.models import params as tparams
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               make_schedule)

from torch_parity import (COND_DIM, COND_LEN, LATENT_DIM, LATENT_TOKENS,
                          _randomize_ada, adapters, normal, params_pair,
                          to_torch)
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

TINY_ENCODER = {"cond_dim": COND_DIM, "cond_len": COND_LEN, "vocab": 256,
                "hidden": 64}
REWARDS = (("text_render", 1.0), ("pickscore", 0.25), ("latent_norm", 0.1))
GEOM = {"latent_dim": LATENT_DIM, "latent_tokens": LATENT_TOKENS,
        "cond_dim": COND_DIM}


def _specs(pairs, spec_cls, extra=None):
    out = []
    for name, w in pairs:
        accepted = {"text_render": GEOM, "pickscore": GEOM,
                    "pref_group": GEOM}.get(name, {})
        args = {k: v for k, v in accepted.items()
                if not (name != "text_render" and k == "latent_tokens")}
        out.append(spec_cls(name, w, args={**args, **(extra or {})}))
    return tuple(out)


def _carry_store(jstore):
    """The JAX loader's {model_id: tower} store as the port's."""
    return {mid: (None if p is None else tparams.from_numpy(
        jax.tree.map(np.asarray, p), "cpu")) for mid, p in jstore.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------- optim
def test_adamw_schedule_and_clip_match_jax_over_three_steps():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    jcfg = JOptim(lr=3e-3, total_steps=10, warmup_steps=2, weight_decay=0.01,
                  grad_clip=0.5)
    tcfg = TOptim(lr=3e-3, total_steps=10, warmup_steps=2, weight_decay=0.01,
                  grad_clip=0.5)
    jp = jax.tree.map(jnp.asarray, tree)
    jst = jadamw_init(jp)
    tp = tparams.from_numpy(tree, "cpu")
    tst = adamw_init(tp)
    jlr, tlr = jschedule(jcfg), make_schedule(tcfg)
    for step in range(3):
        g = {"a": rng.standard_normal((6, 5)).astype(np.float32) * 3,
             "b": {"c": rng.standard_normal((7,)).astype(np.float32) * 3}}
        jg, jn = jclip(jax.tree.map(jnp.asarray, g), jcfg.grad_clip)
        tg, tn = clip_by_global_norm(tparams.from_numpy(g, "cpu"),
                                     tcfg.grad_clip)
        # the schedule in f32 on both sides: equal to the last bit
        assert tlr(step) == float(jlr(jnp.int32(step)))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        jp, jst = jadamw_update(jp, jg, jst, jcfg, jlr(jst.step))
        tp, tst = adamw_update(tp, tg, tst, tcfg, tlr(int(tst.step)))
    assert int(tst.step) == int(jst.step) == 3
    # f32 elementwise updates, products in another order: 1e-6
    for (path, t), (_, j) in zip(tparams.leaves(tp),
                                 tparams.leaves(_np_tree(jp))):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-7)
    for (path, t), (_, j) in zip(tparams.leaves(tst.nu),
                                 tparams.leaves(_np_tree(jst.nu))):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-9)


def test_adamw_state_carried_from_jax_continues_identically():
    """Params and AdamW moments made by two JAX steps, carried across with
    ``from_numpy``, take the same third step in both packages."""
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 4), "b": (4,)}
    cfg_j, cfg_t = JOptim(lr=1e-2), TOptim(lr=1e-2)
    jp = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
          for k, s in shapes.items()}
    jst = jadamw_init(jp)
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    for g in grads[:2]:
        jp, jst = jadamw_update(jp, jax.tree.map(jnp.asarray, g), jst, cfg_j,
                                jnp.float32(1e-2))
    tp = tparams.from_numpy(_np_tree(jp), "cpu")
    tst = adamw_init(tp)._replace(
        step=torch.tensor(int(jst.step), dtype=torch.int32),
        mu=tparams.from_numpy(_np_tree(jst.mu), "cpu"),
        nu=tparams.from_numpy(_np_tree(jst.nu), "cpu"))
    jp, jst = jadamw_update(jp, jax.tree.map(jnp.asarray, grads[2]), jst,
                            cfg_j, jnp.float32(1e-2))
    adamw_update(tp, tparams.from_numpy(grads[2], "cpu"), tst, cfg_t, 1e-2)
    # f32 elementwise arithmetic on identical inputs: 1e-6
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tst.mu[k].numpy(), np.asarray(jst.mu[k]),
                                   rtol=1e-6, atol=1e-7)


def test_adamw_keeps_f32_moments_over_bf16_params():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = adamw_init(p)
    assert st.mu["w"].dtype == torch.float32
    adamw_update(p, {"w": torch.ones(4, dtype=torch.bfloat16)}, st,
                 TOptim(), 1e-2)
    assert p["w"].dtype == torch.bfloat16
    assert float(st.mu["w"][0]) == pytest.approx(0.1)


def test_adamw_chunked_leaves_are_bitwise_the_whole_leaf(monkeypatch):
    """A leaf larger than ``adamw.CHUNK`` is updated a flat chunk of at most
    that many elements at a time; the update is elementwise, so three steps
    with a chunk of 7 (cutting every leaf across its rows) give bitwise the
    params and moments of whole-leaf updates, weight decay and bf16 params
    included."""
    from repro_torch.optim import adamw as tadamw
    g0 = torch.Generator().manual_seed(4)
    p0 = {"stacked": torch.randn(5, 3, 7, generator=g0).bfloat16(),
          "vec": torch.randn(40, generator=g0),
          "mat": torch.randn(3, 11, 2, generator=g0)}
    grads = [{k: torch.randn(v.shape, generator=g0) for k, v in p0.items()}
             for _ in range(3)]
    cfg = TOptim(weight_decay=0.01)

    def run(chunk):
        monkeypatch.setattr(tadamw, "CHUNK", chunk)
        p = {k: v.clone() for k, v in p0.items()}
        st = adamw_init(p)
        for g in grads:
            adamw_update(p, g, st, cfg, 1e-3)
        return p, st

    (pa, sa), (pb, sb) = run(1 << 26), run(7)
    for k in p0:
        assert torch.equal(pa[k], pb[k]) and not torch.equal(pa[k], p0[k])
        assert torch.equal(sa.mu[k], sb.mu[k])
        assert torch.equal(sa.nu[k], sb.nu[k])


# ----------------------------------------------------------------- rewards
@pytest.mark.parametrize("name", ["text_render", "pickscore", "latent_norm",
                                  "pref_group"])
def test_reward_on_carried_towers_matches_jax(name):
    (x0, cond) = normal(3, (6, LATENT_TOKENS, LATENT_DIM),
                        (6, COND_LEN, COND_DIM))
    jl = JLoader(_specs([(name, 1.0)], JSpec), jax.random.PRNGKey(0))
    tl = TLoader(_specs([(name, 1.0)], TSpec), 0, "cpu")
    tl.bind(_carry_store(jl.param_store()))
    want = jl.compute_all(jnp.asarray(x0), {"cond": jnp.asarray(cond)},
                          group_size=3)
    got = tl.compute_all(to_torch(x0), {"cond": to_torch(cond)},
                         group_size=3)
    assert list(got) == list(want)
    for k in want:
        # f32 pooled means and small matmuls in another order: 1e-5
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5)


def test_loader_deduplicates_shared_towers():
    pairs = [("pickscore", 1.0), ("pref_group", 0.5), ("text_render", 1.0)]
    tl = TLoader(_specs(pairs, TSpec), 0, "cpu")
    jl = JLoader(_specs(pairs, JSpec), jax.random.PRNGKey(0))
    # pickscore and pref_group share "pickscore-base"
    assert tl.unique_loads == jl.unique_loads == 2
    assert tl.models[0].params is tl.models[1].params
    assert tl.weight_map() == jl.weight_map()


@pytest.mark.parametrize("agg", ["weighted_sum", "gdpo"])
def test_advantage_aggregation_matches_jax(agg):
    rng = np.random.default_rng(5)
    rew = {f"r{i}": rng.standard_normal(12).astype(np.float32) * (i + 1)
           for i in range(3)}
    w = {"r0": 1.0, "r1": 0.25, "r2": 0.1}
    want = jadvantages(agg, {k: jnp.asarray(v) for k, v in rew.items()}, w,
                       4)
    got = tadvantages(agg, {k: torch.from_numpy(v) for k, v in rew.items()},
                      w, 4)
    # group means and population stds over 4 samples, f32: 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ----------------------------------------------------------------- rollout
def _jax_rollout_draws(ja, key, B, T, mode):
    """The draws ``repro.core.rollout.rollout`` makes from ``key``,
    recomputed as it makes them (rollout.py:91-126)."""
    k_init, k_steps = jax.random.split(key)
    x_init = ja.init_latent(k_init, B)
    if mode == "all_ode":
        return np.asarray(x_init), None
    eps = jnp.stack([jax.random.normal(k, (B, LATENT_TOKENS, LATENT_DIM),
                                       jnp.float32)
                     for k in jax.random.split(k_steps, T)])
    return np.asarray(x_init), np.asarray(eps)


@pytest.mark.parametrize("mode", ["all_sde", "mixed", "all_ode"])
def test_rollout_matches_jax_on_replayed_draws(mode):
    T = 3
    ja, ta = adapters("flow_sde", 0.7, num_steps=T)
    jp, tp = params_pair(ja, jnp.float32)
    (cond,) = normal(6, (2, COND_LEN, COND_DIM))
    cond_g = np.repeat(cond, 2, axis=0)
    key = jax.random.PRNGKey(9)
    mask = (True, False, True)
    js, ts_ = jsched.build("flow_sde", 0.7), tsched.build("flow_sde", 0.7)
    want = jrollout(ja, jp, jnp.asarray(cond_g), key, js, T,
                    jnp.asarray(mask), sde_mode=mode)
    x_init, eps = _jax_rollout_draws(ja, key, 4, T, mode)
    np.testing.assert_array_equal(x_init, np.asarray(want.xs[0]))
    got = trollout(ta, tp, group_repeat(to_torch(cond), 2), None, ts_, T,
                   mask, sde_mode=mode, x_init=to_torch(x_init),
                   eps=None if eps is None else to_torch(eps))
    assert not got.xs.requires_grad
    # f32 through three velocity evaluations of two blocks each: 2e-4 on
    # latents of |x| ~ 1; logp sums 1024 terms per row: rtol 1e-5
    np.testing.assert_allclose(got.xs.numpy(), np.asarray(want.xs),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.logps.numpy(), np.asarray(want.logps),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.sde_mask.numpy(),
                                  np.asarray(want.sde_mask))


def test_group_repeat_and_mix_mask_match_jax():
    from repro.core.rollout import group_repeat as jgr
    from repro.core.rollout import mix_sde_mask as jmix
    (c,) = normal(1, (3, 2, 4))
    np.testing.assert_array_equal(group_repeat(to_torch(c), 3).numpy(),
                                  np.asarray(jgr(jnp.asarray(c), 3)))
    for shift in (0, 2, 5):
        np.testing.assert_array_equal(mix_sde_mask(6, 2, shift).numpy(),
                                      np.asarray(jmix(6, 2, shift)))


# ----------------------------------------------------------------- trainer
def _trainer_pair(clip=0.2, T=3, G=2, agg="gdpo", seed=0):
    """A JAX and a port FlowGRPOTrainer over the reduced flux_dit in f32,
    on one parameter tree (adaLN modulation drawn) and one set of reward
    towers."""
    kw = dict(num_steps=T, group_size=G, clip_range=clip,
              latent_tokens=LATENT_TOKENS, latent_dim=LATENT_DIM,
              advantage_agg=agg)
    jflow = JFlow(**kw, rewards=_specs(REWARDS, JSpec))
    tflow = TFlow(**kw, rewards=_specs(REWARDS, TSpec))
    jopt = JOptim(lr=1e-3, total_steps=10, warmup_steps=2)
    topt = TOptim(lr=1e-3, total_steps=10, warmup_steps=2)
    jtr = jregistry.build("trainer", "flow_grpo",
                          jconfigs.get_reduced("flux_dit"), jflow, jopt,
                          key=jax.random.PRNGKey(seed), cond_dim=COND_DIM,
                          dtype=jnp.float32)
    tree = _randomize_ada(_np_tree(jtr.state.params),
                          np.random.default_rng(seed + 100))
    jp = jax.tree.map(jnp.asarray, tree)
    jtr.state = JRLState(jp, jtr.optimizer.init(jp))
    ttr = tregistry.build("trainer", "flow_grpo",
                          tconfigs.get_reduced("flux_dit"), tflow, topt,
                          device="cpu", cond_dim=COND_DIM,
                          dtype=torch.float32,
                          params=tparams.from_numpy(tree, "cpu"))
    ttr.loader.bind(_carry_store(jtr.loader.param_store()))
    return jtr, ttr


def _jax_step_draws(jtr, cond, key, it):
    """The draws ``BaseTrainer.step`` makes (base.py:334-335 and
    rollout.py:91-126)."""
    k_s, _ = jax.random.split(jax.random.fold_in(key, it))
    B = cond.shape[0] * jtr.flow.group_size
    return _jax_rollout_draws(jtr.adapter, k_s, B, jtr.flow.num_steps,
                              "all_sde")


def test_flow_grpo_step_matches_jax():
    """One full FlowGRPOTrainer.step (rollout, three rewards under gdpo,
    PPO-clip loss and its gradient, global-norm clip, AdamW) on injected
    draws, then a second step on the updated params."""
    jtr, ttr = _trainer_pair()
    (cond,) = normal(8, (2, COND_LEN, COND_DIM))
    key = jax.random.PRNGKey(4)
    for it in range(2):
        x_init, eps = _jax_step_draws(jtr, cond, key, it)
        jm = jax.device_get(jtr.step(jnp.asarray(cond), key, it=it))
        tm = ttr.step(to_torch(cond), 0, it=it, x_init=to_torch(x_init),
                      eps=to_torch(eps))
        # reward_mean: f32 rewards of latents that agree to 2e-4: 1e-4
        np.testing.assert_allclose(float(tm["reward_mean"]),
                                   float(jm["reward_mean"]), atol=1e-4)
        # the loss is ~ -mean(A) with ratio ~ 1: it and the per-step clip
        # fraction agree to the ratio's f32 rounding
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4)
        assert float(tm["clip_frac"]) == float(jm["clip_frac"])
        # the gradient sums T per-step backward passes in f32 against one
        # value_and_grad (measured 1.6e-5 relative): 1e-4 on its norm
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    # AdamW's first steps move each param by ~lr * sign(grad): the params
    # agree to lr / 10 where the two gradients share their sign (all but
    # a few near-zero gradient entries; those differ by at most 2 lr each)
    lr = float(jtr.opt_cfg.lr)
    diffs = [np.abs(t.numpy() - j) for (_, t), (_, j) in zip(
        tparams.leaves(ttr.state.params),
        tparams.leaves(_np_tree(jtr.state.params)))]
    flat = np.concatenate([d.ravel() for d in diffs])
    assert flat.max() <= 4 * lr
    assert np.mean(flat > lr / 10) < 1e-3


def test_grpo_ratio_is_one_at_rollout_params():
    """Recomputing logp under the params that sampled gives ratio 1 and
    clip_frac 0 on the first update (tests/test_trainers.py:66), at the
    reference test's TINY_FLOW sizes."""
    flow = TFlow(num_steps=4, group_size=4, latent_tokens=8, latent_dim=8,
                 clip_range=0.2,
                 rewards=(TSpec("text_render", 1.0,
                                args={"latent_dim": 8, "latent_tokens": 8}),))
    tr = tregistry.build("trainer", "flow_grpo",
                         tconfigs.get_reduced("flux_dit"), flow,
                         TOptim(lr=3e-4, total_steps=50, warmup_steps=2),
                         device="cpu", dtype=torch.float32)
    cond = torch.randn(2, 4, 512, generator=torch.Generator().manual_seed(3))
    m = tr.step(cond, 3, it=0)
    assert float(m["clip_frac"]) < 1e-6
    assert float(m["logp_gap"]) < 1e-3


def test_reward_improves():
    """Fig. 2 at toy scale for flow_grpo, at the reference test's
    LEARN_FLOW sizes (tests/test_trainers.py:38-63): reward rises over 45
    steps."""
    flow = TFlow(num_steps=4, group_size=8, latent_tokens=8, latent_dim=8,
                 clip_range=0.2,
                 rewards=(TSpec("text_render", 1.0,
                                args={"latent_dim": 8, "latent_tokens": 8}),))
    tr = tregistry.build("trainer", "flow_grpo",
                         tconfigs.get_reduced("flux_dit"), flow,
                         TOptim(lr=1e-3, total_steps=135, warmup_steps=2),
                         seed=3, device="cpu")
    cond = torch.randn(8, 4, 512, generator=torch.Generator().manual_seed(3))
    hist = [float(tr.step(cond, 3, it=it)["reward_mean"]) for it in range(45)]
    early, late = np.mean(hist[:5]), np.mean(hist[-10:])
    assert late > early + 0.02, (early, late, hist)


def test_trainer_refuses_unported_layouts_and_policies():
    """Every layout and perf policy is ported: a perf value the reference's
    ``validate`` refuses raises its ``ValueError``, and a layout larger
    than the process group (here none: one device) raises the reference's
    ``resolve_axes`` error."""
    from repro_torch.config import DistConfig, PerfConfig
    flow = TFlow(num_steps=2, group_size=2, latent_tokens=8, latent_dim=8)
    args = (tconfigs.get_reduced("flux_dit"), flow, TOptim())
    with pytest.raises(ValueError, match="perf.remat must be one of"):
        tregistry.build("trainer", "flow_grpo", *args, device="cpu",
                        perf=PerfConfig(remat="blocks"))
    with pytest.raises(ValueError, match="dist.data_parallel=2 but only 1 "
                       "device"):
        tregistry.build("trainer", "flow_grpo", *args, device="cpu",
                        dist=DistConfig(data_parallel=2))


# ------------------------------------------------------------- checkpoints
def _states(dtype_j, dtype_t):
    """A JAX RLState and a port RLState of the same structure (reduced
    flux_dit, moments and step made nonzero)."""
    ja, ta = adapters()
    jp, _ = params_pair(ja, dtype_j)
    rng = np.random.default_rng(1)
    jst = jadamw_init(jp)
    jst = jst._replace(
        step=jnp.int32(7),
        mu=jax.tree.map(lambda m: jnp.asarray(
            rng.standard_normal(m.shape).astype(np.float32)), jst.mu))
    jstate = JRLState(jp, jst)
    tp = tparams.init(ta.spec(), torch.Generator().manual_seed(0), dtype_t,
                      "cpu")
    return jstate, TRLState(tp, adamw_init(tp))


def _assert_bitwise(tstate, jstate):
    """Every leaf of the port's state equals the JAX state's leaf of the
    same key path, bit for bit."""
    from repro.checkpoint.io import _flatten_with_paths
    jl = {k: np.asarray(v) for k, v in _flatten_with_paths(jstate)[0]}
    tl = tckpt.io._flatten(tstate)
    assert {k for k, _ in tl} == set(jl)
    for k, t in tl:
        a, b = tckpt.io._to_numpy(t), jl[k]
        if b.dtype.name == "bfloat16":
            b = b.view(np.uint16)
        np.testing.assert_array_equal(a, b.reshape(a.shape), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_the_packages_bitwise(tmp_path, dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jstate, tlike = _states(jdt, tdt)
    # reference -> port
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, jstate)
    step, tstate = tckpt.restore_latest(str(tmp_path / "j"), tlike)
    assert step == 7 and int(tstate.opt.step) == 7
    assert tstate.params["latent_in"].dtype == tdt
    _assert_bitwise(tstate, jstate)
    # port -> reference
    tckpt.save_checkpoint(str(tmp_path / "t"), 9, tstate)
    step, back = jckpt.restore_latest(str(tmp_path / "t"), jstate)
    assert step == 9
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.atleast_1d(np.asarray(a)).view(np.uint8),
            np.atleast_1d(np.asarray(b)).view(np.uint8))


# -------------------------------------------------- preprocessing and loop
def test_preprocess_cache_written_by_the_reference_feeds_the_port(tmp_path):
    from repro_torch.data import synthetic_prompts
    prompts = synthetic_prompts(5)
    jcache = JCache(str(tmp_path))
    assert jpreprocess(prompts, jcache, **TINY_ENCODER) == 5
    want = JProvider(preprocessing=True, cache=jcache).get(prompts[1:4])
    tp = TProvider(preprocessing=True, cache=TCache(str(tmp_path)),
                   device="cpu")
    got = tp.get(prompts[1:4])
    assert not tp.encoder_resident
    for k in ("cond", "pooled"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(KeyError, match="preprocessing cache"):
        tp.get(["a prompt nobody cached"])
    # the Experiment front doors name the cache sub-directory alike, so a
    # run of either package reads the other's preprocessed conditions
    from repro.api import Experiment as JExperiment
    from repro_torch.api import Experiment as TExperiment
    over = ["--set", "data.encoder=" + json.dumps(TINY_ENCODER),
            "--set", f"flow.cache_dir={tmp_path / 'runs'}"]
    jdir = JExperiment.from_cli(over).build_provider([]).cache.dir
    tdir = TExperiment.from_cli(over + ["--device", "cpu"]).build_provider(
        []).cache.dir
    assert jdir == tdir
    tp.prefetch(prompts[:2])
    np.testing.assert_array_equal(
        tp.get(prompts[:2])["cond"].numpy(),
        np.stack([jcache.get(p)["cond"] for p in prompts[:2]]))


def _train_argv(tmp_path, *extra):
    return ["--reduced", "--steps", "3",
            "--set", "flow.num_steps=2", "--set", "flow.group_size=2",
            "--set", "data.encoder=" + json.dumps(TINY_ENCODER),
            "--set", f"flow.cache_dir={tmp_path / 'cache'}",
            "--set", f"loop.ckpt_dir={tmp_path / 'ckpt'}",
            "--set", f"loop.log_file={tmp_path / 'log.json'}",
            "--set", "loop.log_every=1", *extra]


def test_train_cli_runs_end_to_end_on_cpu_and_resumes(tmp_path, capsys):
    res = ttrain.main(["--device", "cpu", *_train_argv(
        tmp_path, "--set", "loop.save_every=2")])
    hist = res["history"]
    assert [r["step"] for r in hist] == [0, 1, 2]
    for r in hist:
        assert np.isfinite([r["loss"], r["reward"], r["grad_norm"]]).all()
        assert r["encode_resident"] is False
    assert tckpt.latest_step(str(tmp_path / "ckpt")) == 2
    rows = json.loads((tmp_path / "log.json").read_text())
    assert [r["step"] for r in rows] == [0, 1, 2]
    out = capsys.readouterr().out
    assert "[train] flow_grpo on flux_dit-reduced" in out
    # a rerun with more steps resumes from the checkpoint of step 2
    res2 = ttrain.main(["--device", "cpu", *_train_argv(
        tmp_path, "--set", "loop.save_every=2", "--steps", "4")])
    assert res2["start_step"] == 2
    assert [r["step"] for r in res2["history"]] == [2, 3]


def test_train_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(_train_argv(tmp_path))


def test_train_loop_refuses_deeper_pipelines(tmp_path):
    """Deeper pipelines are ported: a ``loop.pipeline=2`` CPU run of the
    train CLI equals the ``pipeline=1`` run, row for row (wall clock aside)
    and in its final params, bitwise."""
    runs = {}
    for k in (1, 2):
        res = ttrain.main(["--device", "cpu", *_train_argv(
            tmp_path / f"k{k}", "--set", f"loop.pipeline={k}")])
        runs[k] = res
    rows = {k: [{n: v for n, v in r.items() if n not in ("dt",
                                                          "steps_per_s")}
                for r in res["history"]] for k, res in runs.items()}
    assert rows[2] == rows[1] and len(rows[1]) == 3
    for (_, a), (_, b) in zip(tparams.leaves(runs[1]["state"].params),
                              tparams.leaves(runs[2]["state"].params)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))

"""Parity of the port's four other trainers (``mix_grpo``, ``grpo_guard``,
``nft``, ``awm``) with the JAX package, on the CPU, the reference's
trainer × backbone cross-combination on the port, and replayed
``flow_grpo`` and ``nft`` steps on the reduced ``mamba2-370m`` (the scan's
closed-form backward against JAX autodiff).

Both packages run on the same numbers: parameters and reward towers are
made by the JAX package and carried across; the JAX package's random draws
(the rollout's init latent and per-step noise, and the update's timesteps
and forward-process noise) are recomputed along its own key path and
injected into the port, because threefry and Philox never match.  The
kernels run their plain versions here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import registry as jregistry
from repro.config import FlowRLConfig as JFlow
from repro.config import OptimConfig as JOptim
from repro.config import RewardSpec as JSpec
from repro.core.rollout import Trajectory as JTrajectory
from repro.core.trainers import RLState as JRLState
from repro_torch import configs as tconfigs
from repro_torch import registry as tregistry
from repro_torch.config import FlowRLConfig as TFlow
from repro_torch.config import OptimConfig as TOptim
from repro_torch.config import RewardSpec as TSpec
from repro_torch.core.rollout import Trajectory as TTrajectory
from repro_torch.models import params as tparams

from test_torch_ssm import COND_LEN as SSM_COND_LEN
from test_torch_ssm import _draw_ssm
from test_torch_training import (REWARDS, _carry_store, _jax_rollout_draws,
                                 _np_tree, _specs)
from torch_parity import (COND_DIM, COND_LEN, LATENT_DIM, LATENT_TOKENS,
                          _randomize_ada, normal, to_torch)
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ALL_TRAINERS = ["flow_grpo", "mix_grpo", "grpo_guard", "nft", "awm"]
NEW_TRAINERS = ["mix_grpo", "grpo_guard", "nft", "awm"]


# ----------------------------------------------------- cross-combination
def test_trainer_registry_equals_the_reference():
    assert tregistry.names("trainer") == jregistry.names("trainer")
    assert sorted(tregistry.names("trainer")) == sorted(ALL_TRAINERS)
    assert {"smollm-360m", "yi-9b", "yi-34b", "qwen3-32b"} <= set(
        tregistry.names("arch"))


# the reference's TINY_FLOW / TINY_OPT (tests/test_trainers.py:14-20)
TINY_FLOW = TFlow(
    num_steps=4, group_size=4, latent_tokens=8, latent_dim=8,
    clip_range=0.2,
    rewards=(TSpec("text_render", 1.0,
                   args={"latent_dim": 8, "latent_tokens": 8}),))
TINY_OPT = TOptim(lr=3e-4, total_steps=50, warmup_steps=2)


@pytest.mark.parametrize("tname", ALL_TRAINERS)
@pytest.mark.parametrize("arch", ["flux_dit", "smollm-360m", "mamba2-370m"])
def test_cross_combination(tname, arch):
    """Any (trainer × backbone family) pair builds and steps from config
    alone (tests/test_trainers.py:27-36), and the step moves the params.
    Mamba-2 trains here through ``SSDScanFn``, whose backward on the CPU is
    the plain closed form ``ref.ssd_scan_bwd_ref``."""
    cfg = tconfigs.get_reduced(arch)
    tr = tregistry.build("trainer", tname, cfg, TINY_FLOW, TINY_OPT,
                         device="cpu")
    before = tparams.state_dict(tr.state.params)
    before = {k: v.clone() for k, v in before.items()}
    cond = torch.randn(2, 4, 512, generator=torch.Generator().manual_seed(3))
    m = tr.step(cond, 3, it=0)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["reward_mean"])
    assert int(tr.state.opt.step) == 1
    after = tparams.state_dict(tr.state.params)
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert all(not p.requires_grad and p.grad is None
               for p in after.values())


def test_sde_modes_and_microbatch_flags_match_the_reference():
    """Which integrator each trainer's rollout takes (the reference's
    dead-branch specialization) and which losses refuse microbatching."""
    cfg = tconfigs.get_reduced("flux_dit")
    want = {"flow_grpo": "all_sde", "grpo_guard": "all_sde",
            "mix_grpo": "mixed", "nft": "all_ode", "awm": "all_ode"}
    for name, mode in want.items():
        tr = tregistry.build("trainer", name, cfg, TINY_FLOW, TINY_OPT,
                             device="cpu")
        jcls = jregistry.lookup("trainer", name)
        assert tr.sde_mode == mode
        assert tr.microbatch_safe == jcls.microbatch_safe
    assert not tregistry.lookup("trainer", "grpo_guard").microbatch_safe


# ------------------------------------------------------- replayed steps
def _trainer_pair(name, T=3, G=2, agg="gdpo", seed=0, arch="flux_dit",
                  **flow_kw):
    """A JAX and a port trainer ``name`` over the reduced ``arch`` in f32,
    on one parameter tree (adaLN modulation drawn for flux_dit, the SSM
    leaves for mamba2-370m) and one set of reward towers."""
    kw = dict(num_steps=T, group_size=G, clip_range=0.2,
              latent_tokens=LATENT_TOKENS, latent_dim=LATENT_DIM,
              advantage_agg=agg, **flow_kw)
    jflow = JFlow(**kw, rewards=_specs(REWARDS, JSpec))
    tflow = TFlow(**kw, rewards=_specs(REWARDS, TSpec))
    jopt = JOptim(lr=1e-3, total_steps=10, warmup_steps=2)
    topt = TOptim(lr=1e-3, total_steps=10, warmup_steps=2)
    jtr = jregistry.build("trainer", name, jconfigs.get_reduced(arch),
                          jflow, jopt, key=jax.random.PRNGKey(seed),
                          cond_dim=COND_DIM, dtype=jnp.float32)
    tree = _randomize_ada(_np_tree(jtr.state.params),
                          np.random.default_rng(seed + 100))
    if arch == "mamba2-370m":
        tree = _draw_ssm(tree, np.random.default_rng(seed + 200))
    jp = jax.tree.map(jnp.asarray, tree)
    jtr.state = JRLState(jp, jtr.optimizer.init(jp))
    ttr = tregistry.build("trainer", name, tconfigs.get_reduced(arch),
                          tflow, topt, device="cpu", cond_dim=COND_DIM,
                          dtype=torch.float32,
                          params=tparams.from_numpy(tree, "cpu"))
    ttr.loader.bind(_carry_store(jtr.loader.param_store()))
    return jtr, ttr


def _update_draws(jtr, key, it, B):
    """The update's draws along the reference's key path: ``k_u`` of
    ``split(fold_in(key, it))`` (base.py:332), then ``k_t, k_eps =
    split(k_u)`` inside the NFT/AWM losses: (t (B,), eps (B, Lt, ld))."""
    _, k_u = jax.random.split(jax.random.fold_in(key, it))
    k_t, k_eps = jax.random.split(k_u)
    t = jtr.sample_timesteps(k_t, B)
    eps = jax.random.normal(k_eps, (B, LATENT_TOKENS, LATENT_DIM),
                            jnp.float32)
    return np.asarray(t), np.asarray(eps)


def _step_draws(jtr, key, it, B):
    """Every draw of one ``BaseTrainer.step`` along the reference's key
    path: the rollout's (x_init, eps; no eps for ODE rollouts) and the
    update's (t, eps)."""
    k_s, _ = jax.random.split(jax.random.fold_in(key, it))
    x_init, eps = _jax_rollout_draws(jtr.adapter, k_s, B, jtr.flow.num_steps,
                                     jtr.sde_mode)
    t_u, eps_u = _update_draws(jtr, key, it, B)
    opt = lambda a: None if a is None else to_torch(a)  # noqa: E731
    return dict(x_init=to_torch(x_init), eps=opt(eps),
                update_t=to_torch(t_u), update_eps=to_torch(eps_u))


# aux metrics each trainer returns beside loss / grad_norm / lr, and the
# absolute band each is held to (the GRPO family's clip fraction exactly)
AUX = {"flow_grpo": {"clip_frac": 0.0},
       "mix_grpo": {"clip_frac": 0.0, "adv_std": 1e-5},
       "grpo_guard": {"clip_frac": 0.0, "adv_std": 1e-5},
       "nft": {"r_mean": 1e-5, "vel_err": 1e-5},
       "awm": {"vel_err": 1e-5, "adv_clip_frac": 0.0}}


def _replay_two_steps(name, jtr, ttr, cond_len, step_draws=None):
    """Two full ``step``s of a trainer pair on the reference's draws
    (``step_draws(jtr, key, it, B)``, by default ``_step_draws``), held
    step by step and at the end (the params after AdamW)."""
    (cond,) = normal(8, (2, cond_len, COND_DIM))
    key = jax.random.PRNGKey(4)
    B = 2 * jtr.flow.group_size
    for it in range(2):
        draws = (step_draws or _step_draws)(jtr, key, it, B)
        jm = jax.device_get(jtr.step(jnp.asarray(cond), key, it=it))
        tm = ttr.step(to_torch(cond), 0, it=it, **draws)
        assert set(tm) - {"logp_gap"} == set(jm)
        # f32 rewards of latents that agree to 2e-4: 1e-4
        np.testing.assert_allclose(float(tm["reward_mean"]),
                                   float(jm["reward_mean"]), atol=1e-4)
        # GRPO family: the loss is ~ -mean(A) with the ratio at its f32
        # rounding (RatioNorm recentres it); NFT/AWM: squared velocity
        # errors of order 1 over 1024 latent elements per sample, f32
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4, rtol=1e-4)
        for k, tol in AUX[name].items():
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=tol,
                                       rtol=tol, err_msg=k)
        # one backward per SDE step (GRPO family) or one over the batch
        # (NFT/AWM) against one value_and_grad, f32: 1e-4 on the norm
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    # AdamW's first steps move each param by ~lr * sign(grad): the params
    # agree to lr / 10 where the two gradients share their sign (all but a
    # few near-zero gradient entries; those differ by at most 2 lr each)
    lr = float(jtr.opt_cfg.lr)
    diffs = [np.abs(t.numpy() - j) for (_, t), (_, j) in zip(
        tparams.leaves(ttr.state.params),
        tparams.leaves(_np_tree(jtr.state.params)))]
    flat = np.concatenate([d.ravel() for d in diffs])
    assert flat.max() <= 4 * lr
    assert np.mean(flat > lr / 10) < 1e-3


@pytest.mark.parametrize("name", NEW_TRAINERS)
def test_trainer_step_matches_jax(name):
    """Two full ``step``s of each new trainer (rollout, three rewards under
    gdpo, the loss and its gradient, global-norm clip, AdamW) on the
    reference's draws, as ``test_flow_grpo_step_matches_jax`` holds
    flow_grpo.  MixGRPO slides its window every step, so the two steps
    train different timesteps."""
    kw = {"sde_window": 2, "sde_window_shift_every": 1} \
        if name == "mix_grpo" else {}
    jtr, ttr = _trainer_pair(name, **kw)
    _replay_two_steps(name, jtr, ttr, COND_LEN)


@pytest.mark.parametrize("name", ["flow_grpo", "nft"])
def test_mamba2_trainer_step_matches_jax(name):
    """Two full ``step``s of ``flow_grpo`` (a loss backward per SDE step)
    and ``nft`` (one over the batch) on the reduced ``mamba2-370m``, SSM
    leaves drawn, on the reference's draws: the port's scan gradient is the
    closed-form backward of ``SSDScanFn``, the reference's JAX autodiff of
    ``ssd_chunked``.  The condition is 31 tokens, so that with the time
    token and 64 latents the sequence is three chunks of 32."""
    jtr, ttr = _trainer_pair(name, arch="mamba2-370m")
    ssm = ttr.state.params["backbone"]["blocks"]["ssm"]
    before = {k: ssm[k].numpy().copy() for k in ("a_log", "dt_bias")}
    _replay_two_steps(name, jtr, ttr, SSM_COND_LEN)
    # a_log reaches the loss only through the scan: its two AdamW moves
    # (and dt_bias's) agree with the reference's to 1e-2 of the largest
    # move (measured <= 1.5e-3 of it), which the global checks above, over
    # 1e5 weights, could not see
    jssm_leaves = _np_tree(jtr.state.params)["backbone"]["blocks"]["ssm"]
    for k, b in before.items():
        want = jssm_leaves[k] - b
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(ssm[k].numpy() - b, want, rtol=0,
                                   atol=1e-2 * np.abs(want).max(),
                                   err_msg=k)


@pytest.mark.parametrize("how", ["uniform", "logit_normal", "discrete"])
def test_sample_timesteps_matches_jax_on_the_same_key_path(how):
    """The three strategies of ``sample_timesteps`` on the update's key
    path (base.py:363-375): each one's base variate (a uniform, a standard
    normal, an index) recomputed from the reference's key, transformed by
    the port as the reference transforms it.  Uniform and logit-normal to
    one f32 ulp of t; discrete picks the same grid point exactly.  Drawn
    from a generator, the port's t stays inside the strategy's support."""
    jtr, ttr = _trainer_pair("awm", T=5, timestep_sampling=how)
    B = 64
    _, k_u = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), 2))
    k_t, _ = jax.random.split(k_u)
    want = np.asarray(jtr.sample_timesteps(k_t, B))
    if how == "uniform":
        draw = jax.random.uniform(k_t, (B,), jnp.float32)
    elif how == "logit_normal":
        draw = jax.random.normal(k_t, (B,), jnp.float32)
    else:
        draw = jax.random.randint(k_t, (B,), 0, jtr.flow.num_steps)
    draw = torch.from_numpy(np.array(draw))
    got = ttr.sample_timesteps(None, B, draw=draw)
    assert got.dtype == torch.float32 and got.shape == (B,)
    if how == "discrete":
        # the same grid point; the grids themselves (numpy's f32 linspace
        # against jnp.linspace) agree to one f32 ulp
        grid = ttr.scheduler.timesteps(ttr.flow.num_steps)[:-1]
        np.testing.assert_array_equal(got.numpy(), grid[draw.numpy()])
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -23, atol=0)
    t = ttr.sample_timesteps(torch.Generator().manual_seed(0), 4096)
    if how == "uniform":
        assert 0.02 <= float(t.min()) and float(t.max()) <= 0.98
    elif how == "logit_normal":
        assert 0.0 < float(t.min()) and float(t.max()) < 1.0
    else:
        grid = ttr.scheduler.timesteps(ttr.flow.num_steps)[:-1]
        assert set(np.unique(t.numpy())) == set(grid)


def _traj_pair(seed, B, T=3):
    """A JAX and a port trajectory over the same (random) states and
    condition; the forward-process losses read only x0 and cond."""
    xs, cond = normal(seed, (T + 1, B, LATENT_TOKENS, LATENT_DIM),
                      (B, COND_LEN, COND_DIM))
    ts = np.linspace(1.0, 0.0, T + 1, dtype=np.float32)
    mask = np.ones(T, bool)
    logps = np.zeros((T, B), np.float32)
    jt = JTrajectory(jnp.asarray(xs), jnp.asarray(logps), jnp.asarray(ts),
                     jnp.asarray(mask), jnp.asarray(cond))
    tt = TTrajectory(to_torch(xs), to_torch(logps), torch.from_numpy(ts),
                     torch.from_numpy(mask), to_torch(cond))
    return jt, tt


def test_nft_with_distinct_ref_params_matches_jax_direct_call():
    """The reference's direct call ``loss_fn(params, traj, adv, key,
    ref_params)`` with a reference policy distinct from ``params``: the port
    takes a second forward under no_grad.  Loss, aux and every gradient
    against ``jax.value_and_grad`` on the same draws.  Passing ``params``
    themselves as the reference gives what the step path's detached
    ``v_ref`` gives, bit for bit."""
    jtr, ttr = _trainer_pair("nft")
    B = 4
    jt, tt = _traj_pair(11, B)
    (adv,) = normal(12, (B,))
    key = jax.random.PRNGKey(13)
    k_t, k_eps = jax.random.split(key)
    t = jtr.sample_timesteps(k_t, B)
    eps = jax.random.normal(k_eps, (B, LATENT_TOKENS, LATENT_DIM),
                            jnp.float32)
    jp = jtr.state.params
    jref = jax.tree.map(lambda a: a + 0.05 * jax.random.normal(
        jax.random.PRNGKey(14), a.shape, a.dtype), jp)
    (jloss, jaux), jgrads = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        jp, jt, jnp.asarray(adv), key, jref)
    # the JAX loss drew these t and eps from the same key
    tp = tparams.from_numpy(_np_tree(jp), "cpu")
    tref = tparams.from_numpy(_np_tree(jref), "cpu")
    leaves = [p for _, p in tparams.leaves(tp)]
    for p in leaves:
        p.requires_grad_(True)
    tloss, taux = ttr.loss_fn(tp, tt, to_torch(adv), None,
                              t=to_torch(t), eps=to_torch(eps),
                              ref_params=tref)
    # f32 forward of two blocks, mean of squared errors of order 1: 1e-5
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for k in ("r_mean", "vel_err"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    assert all(not r.requires_grad and r.grad is None
               for _, r in tparams.leaves(tref))
    # every gradient within 1e-4 of its leaf's max |grad| (f32, two
    # backward orders); leaves the loss does not reach (the LM head, the
    # embedding) get no gradient in the port and zeros in JAX
    for (path, leaf), (_, g_j) in zip(tparams.leaves(tp),
                                      tparams.leaves(_np_tree(jgrads))):
        g_t = (np.zeros_like(g_j) if leaf.grad is None
               else leaf.grad.numpy())
        scale = max(float(np.abs(g_j).max()), 1e-12)
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-4 * scale,
                                   err_msg=str(path))
    # the reference policy equal to params: the same as the step path
    outs = []
    for ref in (None, tp):
        for p in leaves:
            p.grad = None
        loss, aux = ttr.loss_fn(tp, tt, to_torch(adv), None, t=to_torch(t),
                                eps=to_torch(eps), ref_params=ref)
        outs.append((loss, aux["vel_err"],
                     [p.grad.clone() for p in leaves if p.grad is not None]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert len(outs[0][2]) == len(outs[1][2]) > 0
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))


def test_awm_clips_advantages_at_three():
    """AWM's advantage clip (awm.py: adv_clip = 3.0) on a direct call:
    loss and ``adv_clip_frac`` against the reference with advantages
    beyond the clip."""
    jtr, ttr = _trainer_pair("awm")
    B = 4
    jt, tt = _traj_pair(15, B)
    adv = np.array([-5.0, -1.0, 0.5, 4.0], np.float32)
    key = jax.random.PRNGKey(16)
    k_t, k_eps = jax.random.split(key)
    t = jtr.sample_timesteps(k_t, B)
    eps = jax.random.normal(k_eps, (B, LATENT_TOKENS, LATENT_DIM),
                            jnp.float32)
    jloss, jaux = jtr.loss_fn(jtr.state.params, jt, jnp.asarray(adv), key)
    tloss, taux = ttr.backward(tt, to_torch(adv), None, t=to_torch(t),
                               eps=to_torch(eps))
    assert float(taux["adv_clip_frac"]) == float(jaux["adv_clip_frac"]) == 0.5
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)

"""Parity of the port's dense LM family with the JAX package, on the CPU:
the four LM configs (``smollm-360m``, ``yi-9b``, ``yi-34b``,
``qwen3-32b``), their spec trees key for key, the pre-norm block, the
causal ``FlowAdapter.velocity`` over ``[cond; time token; latents]`` on
carried weights, ``rollout_keyed`` on replayed draws, the serve and train
CLIs under ``--arch smollm-360m``, and the run config's defaults.

Parameters are made by the JAX package and carried across with
``repro_torch.models.params.from_numpy``; inputs are made with numpy from a
seed.  The dense blocks carry no adaLN gate, so random weights already make
every block shape the output.  The attention runs its plain version here
(``chip_smoke.py`` holds the causal GQA kernels against it on the card).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.api.experiment import default_cli_config as jdefault_cli_config
from repro.config import FlowRLConfig as JFlowRLConfig
from repro.config import RunConfig as JRunConfig
from repro.core import schedulers as jsched
from repro.core.rollout import request_keys
from repro.core.rollout import rollout_keyed as jrollout_keyed
from repro.models import params as jparams
from repro.models.backbone import Backbone as JBackbone
from repro.models.flow import FlowAdapter as JFlowAdapter
from repro_torch import configs as tconfigs
from repro_torch.api.experiment import default_cli_config
from repro_torch.config import FlowRLConfig as TFlowRLConfig
from repro_torch.config import RunConfig as TRunConfig
from repro_torch.config import from_dict, to_dict
from repro_torch.core import schedulers as tsched
from repro_torch.core.rollout import rollout_keyed as trollout_keyed
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import params as tparams
from repro_torch.models.backbone import Backbone as TBackbone
from repro_torch.models.flow import FlowAdapter as TFlowAdapter

from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

LM_ARCHS = ["smollm-360m", "yi-9b", "yi-34b", "qwen3-32b"]
LATENT_TOKENS, LATENT_DIM = 40, 8
COND_LEN, COND_DIM = 7, 32           # 7 + 1 + 40 = 48 tokens, causal
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _shapes(spec):
    return {p: (tuple(l.shape), tuple(l.axes), l.init)
            for p, l in _spec_leaves(spec)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_config_and_spec_match_jax_key_for_key(arch):
    """Each LM config is the reference's field for field, full and reduced,
    and its adapter spec tree is the reference's key for key (shape, axes,
    init), with no adaLN ``ada`` leaf in the dense blocks."""
    for get_j, get_t in ((jconfigs.get, tconfigs.get),
                         (jconfigs.get_reduced, tconfigs.get_reduced)):
        jc, tc = get_j(arch), get_t(arch)
        jd = dataclasses.asdict(jc)
        td = dataclasses.asdict(tc)
        for k, v in td.items():
            assert jd[k] == v, k
        assert tc.family == "dense"
        flow = dict(latent_tokens=64, latent_dim=16)
        jspec = JFlowAdapter(jc, JFlowRLConfig(**flow), 512).spec()
        tspec = TFlowAdapter(tc, TFlowRLConfig(**flow), 512).spec()
        assert _shapes(jspec) == _shapes(tspec)
        assert "ada" not in tspec["backbone"]["blocks"]
        assert ("q_norm" in tspec["backbone"]["blocks"]["attn"]) == \
            tc.qk_norm
    # smollm-360m at full width: 32 layers, 15 query heads over 5 kv heads
    # of 64, ≈0.41 B parameters with the adapter's projections
    full = tconfigs.get(arch)
    n = tparams.n_params(TFlowAdapter(full, TFlowRLConfig(), 4096).spec())
    if arch == "smollm-360m":
        assert (full.n_layers, full.n_heads, full.n_kv_heads,
                full.resolved_head_dim) == (32, 15, 5, 64)
        assert 0.40e9 < n < 0.42e9


def _adapters(arch, num_steps=3):
    kw = dict(latent_tokens=LATENT_TOKENS, latent_dim=LATENT_DIM,
              num_steps=num_steps)
    ja = JFlowAdapter(jconfigs.get_reduced(arch), JFlowRLConfig(**kw),
                      COND_DIM)
    ta = TFlowAdapter(tconfigs.get_reduced(arch), TFlowRLConfig(**kw),
                      COND_DIM)
    return ja, ta


def _draw_qk(tree, d_model, seed):
    """wq and wk redrawn at std 1/sqrt(d_model) (numpy, the leaves' dtype).
    The repository's init takes a 3-D projection's fan-in from its head
    axis, so q and k have std sqrt(d_model / n_heads) and the attention
    logits std ≈ d_model / n_heads: the softmax is nearly one-hot and the
    stack amplifies any rounding of its inputs (see
    ``test_repository_init_makes_bf16_attention_chaotic``)."""
    rng = np.random.default_rng(seed)
    attn = tree["backbone"]["blocks"]["attn"]
    for k in ("wq", "wk"):
        attn[k] = (rng.standard_normal(attn[k].shape) / d_model ** 0.5
                   ).astype(attn[k].dtype)
    return tree


def _params(spec, dtype, seed=0, draw_qk_for=None):
    p = jparams.init(spec, jax.random.PRNGKey(seed), JAX_DT[dtype])
    tree = jax.tree.map(np.asarray, p)
    if draw_qk_for is not None:
        tree = _draw_qk(tree, draw_qk_for, seed + 100)
    return jax.tree.map(jnp.asarray, tree), tparams.from_numpy(tree, "cpu")


def _velocity_inputs(seed, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, LATENT_TOKENS, LATENT_DIM)).astype(np.float32)
    cond = rng.standard_normal((B, COND_LEN, COND_DIM)).astype(np.float32)
    t = np.array([0.9, 0.35][:B], np.float32)
    return x, t, cond


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_dense_velocity_matches_jax(arch, dtype):
    """The causal velocity of each LM config's reduced variant on carried
    weights.  f32, at the repository's init: matmul reduction order and the
    attention's softmax, 1e-4 of max |v|.  bf16, with wq/wk drawn at
    1/sqrt(d_model) (at the repository's init bf16 rounding of the
    attention inputs alone moves v by a fifth in either package):
    activations round at other places (SwiGLU's g/u and the time MLP round
    to bf16 before silu), 3 % of max |v| and a correlation above 0.999, as
    for flux_dit.  The blocks are live: dropping the last block moves v by
    more than ten bands."""
    ja, ta = _adapters(arch)
    jp, tp = _params(ja.spec(), dtype, seed=1,
                     draw_qk_for=(ta.cfg.d_model if dtype == "bfloat16"
                                  else None))
    x, t, cond = _velocity_inputs(2)
    want = np.asarray(ja.velocity(jp, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(cond)))
    got = ta.velocity(tp, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(cond))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, LATENT_TOKENS, LATENT_DIM)
    got = got.numpy()
    scale = float(np.abs(want).max())
    band = (1e-4 if dtype == "float32" else 3e-2) * scale
    np.testing.assert_allclose(got, want, atol=band, rtol=0)
    if dtype == "bfloat16":
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    one = dataclasses.replace(ta.cfg, n_layers=1)
    tp1 = dict(tp, backbone=dict(tp["backbone"], blocks=jax.tree.map(
        lambda a: a[:1], tp["backbone"]["blocks"])))
    v1 = TFlowAdapter(one, ta.flow_cfg, COND_DIM).velocity(
        tp1, torch.from_numpy(x), torch.from_numpy(t),
        torch.from_numpy(cond)).numpy()
    assert float(np.abs(v1 - got).max()) > 10 * 3e-2 * scale


def test_repository_init_makes_bf16_attention_chaotic():
    """Why the bf16 checks draw wq/wk: at the repository's init the
    reference's own reduced smollm-360m velocity moves by more than a tenth
    of max |v| between bf16 activations and f32 activations on the same
    (bf16) weights, and by under 2 % once wq/wk are drawn at
    1/sqrt(d_model); qk_norm (qwen3-32b) keeps the logits small either
    way."""
    def gap(arch, draw):
        ja, ta = _adapters(arch)
        jp, _ = _params(ja.spec(), "bfloat16", seed=1,
                        draw_qk_for=ta.cfg.d_model if draw else None)
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
        x, t, cond = (jnp.asarray(a) for a in _velocity_inputs(2))
        vb = np.asarray(ja.velocity(jp, x, t, cond))
        vf = np.asarray(ja.velocity(jp32, x, t, cond))
        return float(np.abs(vb - vf).max() / np.abs(vf).max())
    assert gap("smollm-360m", False) > 0.1
    assert gap("smollm-360m", True) < 0.02
    assert gap("qwen3-32b", False) < 0.02


GRAD_FLOW = dict(num_steps=4, group_size=2, latent_tokens=64, latent_dim=64,
                 advantage_agg="gdpo")


def _jax_first_grad_norm(L):
    """The reference's first flow_grpo step's gradient norm at smollm-360m's
    full width and depth L, bf16, on a short sequence (16 + 1 + 64 tokens,
    1 prompt x group 2, T = 4)."""
    from repro import registry as jregistry
    from repro.config import OptimConfig as JOptim
    from repro.config import RewardSpec as JSpec
    cfg = dataclasses.replace(jconfigs.get("smollm-360m"), n_layers=L)
    flow = JFlowRLConfig(**GRAD_FLOW, rewards=(JSpec("latent_norm", 1.0),))
    tr = jregistry.build("trainer", "flow_grpo", cfg, flow, JOptim(),
                         key=jax.random.PRNGKey(0), cond_dim=64)
    cond = np.random.default_rng(1).standard_normal((1, 16, 64))
    m = tr.step(jnp.asarray(cond, jnp.float32), jax.random.PRNGKey(2), it=0)
    return float(m["grad_norm"])


def _port_first_grad_norm(L, draw_qk=False):
    """The same step of the port, with wq/wk drawn at 1/sqrt(d_model) when
    ``draw_qk``."""
    from repro_torch import registry as tregistry
    from repro_torch.config import OptimConfig as TOptim
    from repro_torch.config import RewardSpec as TSpec
    cfg = dataclasses.replace(tconfigs.get("smollm-360m"), n_layers=L)
    flow = TFlowRLConfig(**GRAD_FLOW, rewards=(TSpec("latent_norm", 1.0),))
    tr = tregistry.build("trainer", "flow_grpo", cfg, flow, TOptim(),
                         device="cpu", cond_dim=64)
    if draw_qk:
        g = torch.Generator().manual_seed(7)
        attn = tr.state.params["backbone"]["blocks"]["attn"]
        for k in ("wq", "wk"):
            attn[k].copy_(torch.randn(attn[k].shape, generator=g)
                          / cfg.d_model ** 0.5)
    cond = np.random.default_rng(1).standard_normal((1, 16, 64))
    m = tr.step(torch.from_numpy(cond).float(), 2, it=0)
    return float(m["grad_norm"])


def test_repository_init_explodes_gradients_with_depth():
    """Why the card's dense train path draws wq/wk: at the repository's
    init the reference's first-step gradient norm at smollm-360m's width
    grows by more than 100x from 1 to 5 layers, and the port's alike (at 32
    layers over 4609 tokens it overflows to inf on the card); with wq/wk
    drawn at 1/sqrt(d_model) the port's stays within 10x."""
    j1, j5 = _jax_first_grad_norm(1), _jax_first_grad_norm(5)
    t1, t5 = _port_first_grad_norm(1), _port_first_grad_norm(5)
    assert j5 > 100 * j1 and t5 > 100 * t1, (j1, j5, t1, t5)
    d1, d5 = (_port_first_grad_norm(1, True), _port_first_grad_norm(5, True))
    assert d5 < 10 * d1, (d1, d5)


def test_dense_backbone_is_causal_and_matches_jax():
    """``forward_embeds`` of the reduced smollm-360m backbone in f32 on
    carried weights: 1e-4 of max |h|; changing the last token leaves every
    earlier position bitwise unchanged (causal), and the backbone takes no
    adaLN conditioning."""
    cfg_j, cfg_t = (jconfigs.get_reduced("smollm-360m"),
                    tconfigs.get_reduced("smollm-360m"))
    jb, tb = JBackbone(cfg_j), TBackbone(cfg_t)
    jp, tp = _params(jb.spec(), "float32", seed=3)
    x = np.random.default_rng(4).standard_normal(
        (2, 33, cfg_t.d_model)).astype(np.float32)
    want, _, _ = jb.forward_embeds(jp, jnp.asarray(x), causal=True)
    got = tb.forward_embeds(tp, torch.from_numpy(x), causal=True)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    x2 = x.copy()
    x2[:, -1] += 1.0
    got2 = tb.forward_embeds(tp, torch.from_numpy(x2), causal=True)
    assert torch.equal(got2[:, :-1], got[:, :-1])
    assert not torch.equal(got2[:, -1], got[:, -1])


def _jax_draws(ja, keys, num_steps):
    """The draws ``repro.core.rollout.rollout_keyed`` makes, recomputed as
    it makes them (rollout.py:171-186)."""
    shape = (LATENT_TOKENS, LATENT_DIM)
    k2 = jax.vmap(jax.random.split)(keys)
    k_init, k_step = k2[:, 0], k2[:, 1]
    x_init = jax.vmap(lambda k: ja.init_latent(k, 1)[0])(k_init)
    eps = jnp.stack([jax.vmap(lambda k: jax.random.normal(
        jax.random.fold_in(k, i), shape, jnp.float32))(k_step)
        for i in range(num_steps)])
    return np.asarray(x_init), np.asarray(eps)


def test_rollout_keyed_matches_jax_on_replayed_draws():
    """The serving path's rollout of the reduced smollm-360m, f32, three
    flow_sde steps on the reference's per-request draws: latents 2e-4,
    log-densities rtol 1e-5, as for flux_dit and mamba2-370m."""
    ja, ta = _adapters("smollm-360m")
    jp, tp = _params(ja.spec(), "float32", seed=5)
    cond = np.random.default_rng(9).standard_normal(
        (3, COND_LEN, COND_DIM)).astype(np.float32)
    keys = request_keys(jax.random.PRNGKey(0), 3)
    js, ts_ = jsched.build("flow_sde", 0.7), tsched.build("flow_sde", 0.7)
    want = jrollout_keyed(ja, jp, jnp.asarray(cond), keys, js, 3)
    x_init, eps = _jax_draws(ja, keys, 3)
    got = trollout_keyed(ta, tp, torch.from_numpy(cond), [0, 1, 2], ts_, 3,
                         x_init=torch.from_numpy(x_init),
                         eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.x0.numpy(), np.asarray(want.x0),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.logps.numpy(), np.asarray(want.logps),
                               rtol=1e-5)


def test_dense_checkpoint_crosses_between_the_packages_bitwise(tmp_path):
    """A reduced smollm-360m RLState (bf16 params, f32 AdamW moments, step)
    written by the reference restores in the port bit for bit, and back."""
    from repro import checkpoint as jckpt
    from repro.core.trainers import RLState as JRLState
    from repro.optim import adamw_init as jadamw_init
    from repro_torch import checkpoint as tckpt
    from repro_torch.core.trainers import RLState as TRLState
    from repro_torch.optim import adamw_init
    ja, ta = _adapters("smollm-360m")
    jp, _ = _params(ja.spec(), "bfloat16", seed=8)
    rng = np.random.default_rng(9)
    jst = jadamw_init(jp)._replace(step=jnp.int32(3), nu=jax.tree.map(
        lambda m: jnp.asarray(rng.random(m.shape, np.float32)),
        jadamw_init(jp).nu))
    jstate = JRLState(jp, jst)
    tp = tparams.init(ta.spec(), torch.Generator().manual_seed(0),
                      torch.bfloat16, "cpu")
    jckpt.save_checkpoint(str(tmp_path / "j"), 3, jstate)
    step, tstate = tckpt.restore_latest(str(tmp_path / "j"),
                                        TRLState(tp, adamw_init(tp)))
    assert step == 3 and int(tstate.opt.step) == 3
    for (path, t), (_, j) in zip(tparams.leaves(tstate.params),
                                 tparams.leaves(jax.tree.map(np.asarray,
                                                             jp))):
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      j.view(np.int16), err_msg=str(path))
    for (_, t), (_, j) in zip(tparams.leaves(tstate.opt.nu),
                              tparams.leaves(jax.tree.map(np.asarray,
                                                          jst.nu))):
        np.testing.assert_array_equal(t.numpy(), j)
    tckpt.save_checkpoint(str(tmp_path / "t"), 4, tstate)
    step, back = jckpt.restore_latest(str(tmp_path / "t"), jstate)
    assert step == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(
            np.atleast_1d(np.asarray(a)).view(np.uint8),
            np.atleast_1d(np.asarray(b)).view(np.uint8))


# ------------------------------------------------------------------- CLIs
TINY_ENCODER = {"cond_dim": COND_DIM, "cond_len": COND_LEN, "vocab": 256,
                "hidden": 64}


def test_serve_cli_runs_smollm_reduced_on_cpu(tmp_path):
    out = tserve.main([
        "--arch", "smollm-360m", "--reduced", "--device", "cpu",
        "--sde", "flow_sde", "--requests", "3", "--max-batch", "2",
        "--set", "flow.num_steps=2",
        "--set", f"flow.latent_tokens={LATENT_TOKENS}",
        "--set", f"flow.latent_dim={LATENT_DIM}",
        "--set", f"data.encoder={json.dumps(TINY_ENCODER)}"])
    lat = out["latents"]
    assert tuple(lat.shape) == (3, LATENT_TOKENS, LATENT_DIM)
    assert torch.isfinite(lat).all()
    assert out["engine"].adapter.cfg.family == "dense"


@pytest.mark.parametrize("trainer", ["flow_grpo", "mix_grpo", "grpo_guard",
                                     "nft", "awm"])
def test_train_cli_runs_smollm_reduced_on_cpu(tmp_path, capsys, trainer):
    res = ttrain.main([
        "--device", "cpu", "--arch", "smollm-360m", "--reduced",
        "--trainer", trainer, "--steps", "2",
        "--set", "flow.num_steps=2", "--set", "flow.group_size=2",
        "--set", f"data.encoder={json.dumps(TINY_ENCODER)}",
        "--set", f"flow.cache_dir={tmp_path / 'cache'}",
        "--set", f"loop.ckpt_dir={tmp_path / 'ckpt'}",
        "--set", "loop.save_every=2", "--set", "loop.log_every=1"])
    hist = res["history"]
    assert [r["step"] for r in hist] == [0, 1]
    for r in hist:
        assert np.isfinite([r["loss"], r["reward"], r["grad_norm"]]).all()
    assert int(res["state"].opt.step) == 2
    assert f"[train] {trainer} on smollm-360m-reduced" in \
        capsys.readouterr().out


# ----------------------------------------------------------------- config
def test_run_config_defaults_match_the_reference():
    """``RunConfig``'s default arch is the reference's (smollm-360m); the
    CLI profile keeps flux_dit, as the reference's does."""
    assert TRunConfig().arch == JRunConfig().arch == "smollm-360m"
    assert default_cli_config().arch == jdefault_cli_config().arch \
        == "flux_dit"


def test_reference_flow_config_loads_into_the_port():
    """A reference run.json's ``flow`` section, the NFT/AWM timestep
    sampling and MixGRPO's window included, loads into the port's strict
    ``from_dict`` field for field, and a typo is still refused."""
    jflow = dataclasses.replace(
        JFlowRLConfig(), trainer_type="mix_grpo",
        timestep_sampling="logit_normal", sde_window=1,
        sde_window_shift_every=3)
    raw = json.loads(json.dumps(dataclasses.asdict(jflow)))
    port = from_dict(TFlowRLConfig, raw)
    assert json.loads(json.dumps(to_dict(port))) == raw
    assert json.loads(json.dumps(to_dict(TFlowRLConfig()))) == json.loads(
        json.dumps(dataclasses.asdict(JFlowRLConfig())))
    run = from_dict(TRunConfig, {"arch": "smollm-360m", "flow": raw})
    assert run.flow.sde_window == 1
    with pytest.raises(TypeError, match="sde_windw"):
        from_dict(TFlowRLConfig, dict(raw, sde_windw=2))

"""Parity of the port's MoE family (``grok-1-314b``: 8 experts top-2;
``deepseek-v2-236b``: multi-head latent attention, a first dense layer, 2
shared and 160 routed experts top-6) with the JAX package, on the CPU.

Both archs' configs, spec trees and counts at full and reduced size; the
mixture of experts (``models/moe.py``) in its slot-dispatch and dense modes
with its auxiliary losses, the dropped set at capacity, and the
reference's two MoE tests; the latent attention's ``apply_full``
(``models/mla.py``); the plain attention at a value dim unlike the query
dim (48 / 32) against the reference's interpret-mode Pallas kernel and
``jax.vjp`` of its jnp ``attention_chunked``; the reduced backbone and
velocity, ``rollout_keyed``, replayed ``flow_grpo`` and ``nft`` steps,
``remat="block"`` and the CLIs.

Parameters are made by the JAX package and carried across with
``repro_torch.models.params.from_numpy``; inputs are made with numpy from a
seed.  The attention's query and key projections are drawn: grok's wq/wk
at 1/sqrt(d_model) as the dense family's are (test_torch_dense.py), the
latent attention's w_uq/w_uk at 1/sqrt(their latent rank).  The
repository's init takes their fan-in from the head axis, and the
amplified logits make the packages' f32 rounding visible: in grok's
forward, and in DeepSeek-V2's second training step
(``test_repository_init_and_the_attention``).  Every tolerance is f32
unless a test says otherwise.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import registry as jregistry
from repro.config import FlowRLConfig as JFlowRLConfig
from repro.config import MoEConfig as JMoE
from repro.core import schedulers as jsched
from repro.core.rollout import request_keys
from repro.core.rollout import rollout_keyed as jrollout_keyed
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import params as jparams
from repro.models.backbone import Backbone as JBackbone
from repro.models.flow import FlowAdapter as JFlowAdapter
from repro.models.layers import attention_chunked as jattention_chunked
from repro_torch import configs as tconfigs
from repro_torch import registry as tregistry
from repro_torch.api import Experiment as TExperiment
from repro_torch.config import FlowRLConfig as TFlowRLConfig
from repro_torch.config import MoEConfig as TMoE
from repro_torch.config import OptimConfig as TOptim
from repro_torch.config import PerfConfig as TPerf
from repro_torch.config import RewardSpec as TSpec
from repro_torch.config import RunConfig as TRunConfig
from repro_torch.core import schedulers as tsched
from repro_torch.core.rollout import rollout_keyed as trollout_keyed
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import DIM_PAIRS
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models.backbone import Backbone as TBackbone
from repro_torch.models.flow import FlowAdapter as TFlowAdapter

from test_torch_trainers import _replay_two_steps, _trainer_pair
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ARCHS = ["grok-1-314b", "deepseek-v2-236b"]
LATENT_TOKENS, LATENT_DIM = 64, 16
COND_LEN, COND_DIM = 4, 32


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _shapes(spec):
    return {p: (tuple(l.shape), tuple(l.axes), l.init)
            for p, l in _spec_leaves(spec)}


def _draw_qk(tree, d_model, rng):
    """Every GQA block's wq and wk (grok) redrawn at std 1/sqrt(d_model),
    every MLA block's w_uq and w_uk (deepseek; (rank, heads, dim)) at
    1/sqrt(rank), in place (module docstring)."""
    if isinstance(tree, dict):
        for k in ("wq", "wk", "w_uq", "w_uk"):
            if k in tree:
                fan_in = d_model if k in ("wq", "wk") else \
                    tree[k].shape[-3]
                tree[k] = (rng.standard_normal(tree[k].shape)
                           / fan_in ** 0.5).astype(tree[k].dtype)
        for v in tree.values():
            _draw_qk(v, d_model, rng)
    return tree


def _params(spec, d_model, dtype=jnp.float32, seed=0, draw_qk=True):
    """JAX params (wq/wk drawn unless ``draw_qk`` is False) and the same
    tree on the port's CPU, bit for bit."""
    tree = jax.tree.map(np.asarray,
                        jparams.init(spec, jax.random.PRNGKey(seed), dtype))
    if draw_qk:
        tree = _draw_qk(tree, d_model, np.random.default_rng(seed + 200))
    return jax.tree.map(jnp.asarray, tree), tparams.from_numpy(tree, "cpu")


def _pair(arch):
    return jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------ config, spec
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_spec_and_counts_match_jax(arch, reduced):
    """The config field for field, the adapter's spec tree key for key
    (shape, logical axes, init: deepseek's first dense layer stacked apart
    as ``dense_blocks``, the stacked expert tables, the shared experts),
    ``n_params`` / ``n_active_params`` and ``describe()["arch"]`` equal to
    the reference's."""
    get_j = jconfigs.get_reduced if reduced else jconfigs.get
    get_t = tconfigs.get_reduced if reduced else tconfigs.get
    jc, tc = get_j(arch), get_t(arch)
    jd = dataclasses.asdict(jc)
    for k, v in dataclasses.asdict(tc).items():
        assert jd[k] == v, k
    assert tc.family == "moe"
    flow = dict(latent_tokens=64, latent_dim=16)
    jspec = JFlowAdapter(jc, JFlowRLConfig(**flow), 512).spec()
    tspec = TFlowAdapter(tc, TFlowRLConfig(**flow), 512).spec()
    assert _shapes(jspec) == _shapes(tspec)
    bb = tspec["backbone"]
    fk = tc.moe.first_k_dense
    assert ("dense_blocks" in bb) == bool(fk)
    assert bb["blocks"]["ffn"]["w_gate"].shape == (
        tc.n_layers - fk, tc.moe.n_experts, tc.d_model, tc.moe.expert_d_ff)
    assert ("shared" in bb["blocks"]["ffn"]) == bool(tc.moe.n_shared_experts)
    assert ("w_uq" in bb["blocks"]["attn"]) == (tc.mla is not None)
    assert (tc.n_params(), tc.n_active_params()) == (jc.n_params(),
                                                     jc.n_active_params())
    if not reduced:
        assert tc.n_params() == {"grok-1-314b": 316_489_340_928,
                                 "deepseek-v2-236b": 235_741_312_000}[arch]
    assert tregistry.build("arch", arch, reduced=reduced) == tc
    got = TExperiment(TRunConfig(arch=arch, reduced=reduced),
                      device="cpu").describe()["arch"]
    assert got == {"name": jc.name, "family": "moe",
                   "n_params": jc.n_params()}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_from_numpy_round_trips_the_moe_tree_bitwise(arch, dtype):
    """The reference's whole adapter tree (``dense_blocks``, the stacked
    expert tables, ``shared``, the MLA projections) crosses key for key and
    bit for bit, in f32 and bf16."""
    jc, tc = _pair(arch)
    ja = JFlowAdapter(jc, JFlowRLConfig(latent_tokens=8, latent_dim=8), 32)
    tree = jax.tree.map(np.asarray,
                        jparams.init(ja.spec(), jax.random.PRNGKey(3), dtype))
    sd = tparams.state_dict(tparams.from_numpy(tree, "cpu"))
    flat = dict(tparams.leaves(tree))
    assert set(sd) == {".".join(k) for k in flat}
    for k, a in flat.items():
        t = sd[".".join(k)]
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)


# ------------------------------------------------------------------ moe
def _moe_pair(arch, seed=0, moe=None):
    jc, tc = _pair(arch)
    if moe is not None:
        jc = dataclasses.replace(jc, moe=JMoE(**moe))
        tc = dataclasses.replace(tc, moe=TMoE(**moe))
    p = jax.tree.map(np.asarray, jparams.init(jmoe.spec(jc),
                                              jax.random.PRNGKey(seed),
                                              jnp.float32))
    return jc, tc, jax.tree.map(jnp.asarray, p), tparams.from_numpy(p, "cpu")


@pytest.mark.parametrize("mode", ["tensor", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, mode, monkeypatch):
    """``moe.apply`` of both reduced configs (grok: 4 experts top-2;
    deepseek: 4 experts top-2 and a shared expert) in the slot-dispatch and
    the dense mode, over 2 sequences of 40 tokens: the output within 1e-5
    of max |y| (f32 products in another order), the load-balance and
    z-losses within rtol 1e-5, the same top-k assignments."""
    monkeypatch.setenv("REPRO_MOE_MODE", mode)
    jc, tc, jp, tp = _moe_pair(arch)
    x = _x((2, 40, jc.d_model), 1)
    want, jaux = jmoe.apply(jp, jc, jnp.asarray(x))
    got, taux = tmoe.apply(tp, tc, torch.from_numpy(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert set(taux) == set(jaux) == {"moe_lb_loss", "moe_z_loss"}
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-5)


def _skewed(d, T, seed):
    """Tokens that all lie near one direction, so most of them pick the
    same experts and the capacity binds."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(d)
    return (base + 0.05 * rng.standard_normal((2, T, d))).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_capacity_drops_the_reference_s_set(arch):
    """16 experts top-2 over 2 sequences of 40 skewed tokens: capacity 12
    slots an expert against ~40 assignments to the favourite ones, so most
    are dropped.  The port keeps and drops exactly the reference's
    assignments (rank within expert in token order) and its output agrees
    within 1e-5 of max |y|."""
    moe = dict(n_experts=16, top_k=2, expert_d_ff=32,
               n_shared_experts=1 if arch == "deepseek-v2-236b" else 0)
    jc, tc, jp, tp = _moe_pair(arch, seed=2, moe=moe)
    T = 40
    x = _skewed(jc.d_model, T, 3)
    C = tmoe.capacity(T, tc)
    assert C == jmoe.capacity(T, jc) == 12
    logits = x @ np.asarray(jp["router"])
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    _, jidx = jax.lax.top_k(probs, 2)
    _, tidx = torch.topk(torch.softmax(torch.from_numpy(logits), -1), 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    slot, keep = tmoe._slots(tidx, 16, C)
    jslot, jkeep = jax.vmap(lambda i: jmoe._slots_one_group(i, 16, C))(jidx)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    assert 0.3 < 1 - keep.float().mean() < 0.9
    got, _ = tmoe.apply(tp, tc, torch.from_numpy(x))
    want = np.asarray(jmoe.apply(jp, jc, jnp.asarray(x))[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_moe_gradients_at_capacity_match_jax():
    """The backward where the capacity binds (16 experts top-2, 40 skewed
    tokens a sequence, most assignments dropped, many slots empty):
    ``jax.grad`` of the reference's output against the port's for every
    parameter leaf and the input, within 1e-4 of each max |grad|.  Dropped
    assignments give their gates and rows no gradient in either."""
    moe = dict(n_experts=16, top_k=2, expert_d_ff=32, n_shared_experts=1)
    jc, tc, jp, tp = _moe_pair("deepseek-v2-236b", seed=2, moe=moe)
    x = _skewed(jc.d_model, 40, 3)
    r = _x((2, 40, jc.d_model), 4)

    def jloss(p, x):
        return (jmoe.apply(p, jc, x)[0] * r).sum()

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_()
              for k, v in tparams.state_dict(tp).items()}
    tree = {"shared": {}}
    for k, v in leaves.items():
        if k.startswith("shared."):
            tree["shared"][k.split(".")[1]] = v
        else:
            tree[k] = v
    xt = torch.from_numpy(x).requires_grad_()
    (tmoe.apply(tree, tc, xt)[0] * torch.from_numpy(r)).sum().backward()
    for k, w in tparams.leaves(jax.tree.map(np.asarray, jg)):
        g = leaves[".".join(k)].grad
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=".".join(k))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jgx)).max())


@pytest.mark.parametrize("route", ["autograd_grad", "backward_inputs"])
def test_moe_table_gradients_reach_autograd(route):
    """The router's and expert tables' gradients are plain autograd's, on
    the capacity case above: ``torch.autograd.grad`` returns them and
    leaves ``.grad`` unset, and ``backward(inputs=...)`` fills only the
    named leaves' ``.grad``.  Either way they equal ``jax.grad`` of the
    reference within 1e-4 of each max |grad|."""
    moe = dict(n_experts=16, top_k=2, expert_d_ff=32, n_shared_experts=1)
    jc, tc, jp, tp = _moe_pair("deepseek-v2-236b", seed=2, moe=moe)
    x = _skewed(jc.d_model, 40, 3)
    r = _x((2, 40, jc.d_model), 4)
    jg = jax.grad(lambda p: (jmoe.apply(p, jc, jnp.asarray(x))[0]
                             * r).sum())(jp)
    names = ("router", "w_gate", "w_up", "w_down")
    tree = {k: v.clone().requires_grad_() if k in names else v
            for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    loss = (tmoe.apply(tree, tc, xt)[0] * torch.from_numpy(r)).sum()
    if route == "autograd_grad":
        got = dict(zip(names, torch.autograd.grad(
            loss, [tree[k] for k in names])))
        assert all(tree[k].grad is None for k in names)
    else:
        loss.backward(inputs=[tree[k] for k in names])
        got = {k: tree[k].grad for k in names}
        assert xt.grad is None
    for k in names:
        w = np.asarray(jg[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_moe_matches_dense_oracle_when_capacity_ample():
    """The reference's test on the port: with capacity >= tokens, the slot
    dispatch equals computing every expert densely and mixing by gates
    (atol 1e-4, rtol 1e-3)."""
    cfg = tconfigs.get_reduced("grok-1-314b")
    p = jax.tree.map(np.asarray, jparams.init(
        jmoe.spec(jconfigs.get_reduced("grok-1-314b")),
        jax.random.PRNGKey(0), jnp.float32))
    tp = tparams.from_numpy(p, "cpu")
    x = torch.from_numpy(_x((2, 16, cfg.d_model), 3))
    y, aux = tmoe.apply(tp, cfg, x)
    m = cfg.moe
    probs = torch.softmax(x @ tp["router"], -1)
    gates, idx = torch.topk(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True)
    g = torch.einsum("btd,edf->btef", x, tp["w_gate"])
    u = torch.einsum("btd,edf->btef", x, tp["w_up"])
    all_y = torch.einsum("btef,efd->bted",
                         torch.nn.functional.silu(g) * u, tp["w_down"])
    sel = torch.gather(all_y, 2, idx[..., None].expand(*idx.shape,
                                                       cfg.d_model))
    want = (sel * gates[..., None]).sum(2)
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-4, rtol=1e-3)
    assert torch.isfinite(aux["moe_lb_loss"])


def test_moe_capacity_drops_tokens():
    """The reference's test on the port: 4 experts top-4 (every token picks
    every expert) over 64 identical tokens, capacity below the 256
    assignments; the output stays finite."""
    cfg = dataclasses.replace(tconfigs.get_reduced("grok-1-314b"),
                              moe=TMoE(n_experts=4, top_k=4, expert_d_ff=64))
    p = tparams.init(tmoe.spec(cfg), torch.Generator().manual_seed(0),
                     torch.float32, "cpu")
    x = torch.ones((1, 64, cfg.d_model)) * 0.1
    C = tmoe.capacity(64, cfg)
    assert C < 64 * 4
    y, _ = tmoe.apply(p, cfg, x)
    assert torch.isfinite(y).all()


def test_moe_gradients_reach_every_routed_leaf():
    """A backward through the slot dispatch reaches the router, every
    expert table and the input; the gradients equal ``jax.grad`` of the
    reference's ``apply`` (sum of outputs plus both auxiliary losses)
    within 1e-4 of each leaf's max |grad|."""
    jc, tc, jp, tp = _moe_pair("deepseek-v2-236b", seed=4)
    x = _x((2, 24, jc.d_model), 5)

    def jloss(p, x):
        y, aux = jmoe.apply(p, jc, x)
        return y.sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in
              tparams.state_dict(tp).items()}
    tree = {}
    for k, v in leaves.items():
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = tmoe.apply(tree, tc, xt)
    (y.sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]).backward()
    for k, w in tparams.leaves(jax.tree.map(np.asarray, jg)):
        g = leaves[".".join(k)].grad
        assert g is not None, k
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=".".join(k))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jgx)).max())


# ------------------------------------------------------------------ mla
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_mla_apply_full_matches_jax(causal):
    """The latent attention's train/prefill path of the reduced deepseek
    (8 heads, q/k 32 + 16 rope = 48 wide, v 32) over 2 sequences of 24
    tokens: within 1e-5 of max |out|.  The attention runs the plain version
    at (48, 32), scaled by 48^-1/2 (the reference's explicit scale)."""
    jc, tc = _pair("deepseek-v2-236b")
    p = jax.tree.map(np.asarray, jparams.init(jmla.spec(jc),
                                              jax.random.PRNGKey(6),
                                              jnp.float32))
    x = _x((2, 24, jc.d_model), 7)
    want, _ = jmla.apply_full(jax.tree.map(jnp.asarray, p), jc,
                              jnp.asarray(x), causal=causal)
    got, _ = tmla.apply_full(tparams.from_numpy(p, "cpu"), tc,
                             torch.from_numpy(x), causal=causal)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------- the attention at a value dim of its own
DV_CASES = [  # B, S, H, K, causal, window
    (2, 128, 4, 2, True, 0),
    (1, 96, 2, 2, True, 32),
    (1, 77, 4, 2, False, 0),
]


def _qkv_dv(B, S, H, K, seed, D=48, Dv=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, Dv),
                      (B, S, H, Dv))]


@pytest.mark.parametrize("B,S,H,K,causal,window", DV_CASES,
                         ids=["causal", "window", "bidir"])
def test_attention_dv_forward_matches_pallas_and_chunked(B, S, H, K, causal,
                                                         window):
    """The port's plain attention at (D, Dv) = (48, 32), scaled by 48^-1/2,
    against the reference's Pallas kernel in interpret mode (64-row blocks;
    the ragged 77 in one block) and its jnp ``attention_chunked``: 2e-5
    (tests/test_kernels.py's tolerance)."""
    qn, kn, vn, _ = _qkv_dv(B, S, H, K, S + H)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (qn, kn, vn)),
                              causal=causal, window=window)
    assert tuple(out.shape) == (B, S, H, 32)
    blk = 64 if S % 64 == 0 else S
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    for want in (jflash(jq, jk, jv, causal=causal, window=window,
                        block_q=blk, block_k=blk, interpret=True),
                 jattention_chunked(jq, jk, jv, causal=causal,
                                    window=window, chunk_q=32)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("B,S,H,K,causal,window", DV_CASES,
                         ids=["causal", "window", "bidir"])
def test_attention_dv_backward_matches_jax_vjp(B, S, H, K, causal, window):
    """The plain backward at (48, 32) (``ref.flash_attention_bwd_ref`` from
    the forward's o and log-sum-exp) and the autograd Function on CPU
    tensors against ``jax.vjp`` of the reference's ``attention_chunked``:
    each of dq, dk (48 wide), dv (32 wide) within 1e-5 of its max
    |reference|."""
    qn, kn, vn, gn = _qkv_dv(B, S, H, K, 3 * S + H)
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    _, vjp = jax.vjp(lambda q, k, v: jattention_chunked(
        q, k, v, causal=causal, window=window, chunk_q=32), jq, jk, jv)
    want = [np.asarray(g) for g in vjp(jnp.asarray(gn))]
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, gn))
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                         window=window)
    plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    ops.flash_attention(*leaves, causal=causal,
                        window=window).backward(do)
    for got in (plain, [a.grad for a in leaves]):
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            assert tuple(g.shape) == w.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)


def test_the_kernel_wrapper_takes_the_mla_pair_and_refuses_others():
    """The CUDA wrapper is built for every equal pair and (192, 128); it
    refuses any other pair by shape before it looks at the device, and
    takes (192, 128) as far as the device check."""
    assert (192, 128) in DIM_PAIRS and (128, 128) in DIM_PAIRS
    q = torch.zeros(1, 8, 2, 192)
    for dv in (64, 192):
        with pytest.raises(ValueError, match="not in"):
            cuda_flash(q, q, torch.zeros(1, 8, 2, dv))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_flash(q, q, torch.zeros(1, 8, 2, 128))


def test_attention_launches_are_counted_by_dim_pair():
    """Both attention wrappers count their launches by dim pair
    (``pair_launches``, one key per pair of ``DIM_PAIRS``), and
    ``kernels.counts``, which moves a graph's counts between capture and
    replay, reads and adds them with the rest; a refused call counts
    nothing."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    keys = {f"{d}x{dv}" for d, dv in DIM_PAIRS}
    for fn in (cuda_flash, flash_attention_bwd):
        assert set(fn.pair_launches) == keys
    start = counts.read()
    with pytest.raises(ValueError):
        cuda_flash(torch.zeros(1, 8, 2, 192), torch.zeros(1, 8, 2, 192),
                   torch.zeros(1, 8, 2, 128))
    assert counts.read() == start
    cuda_flash.launches += 3
    cuda_flash.pair_launches["192x128"] += 3
    flash_attention_bwd.pair_launches["192x128"] += 1
    flash_attention_bwd.launches += 1
    captured = counts.since(start)
    assert {k: n for k, n in captured.items() if n} == {
        "flash_attention": 3, "flash_attention@192x128": 3,
        "flash_attention_bwd": 1, "flash_attention_bwd@192x128": 1}
    counts.add(captured, times=-1)
    assert counts.read() == start


# ------------------------------------------------------------- backbone
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_backbone_matches_jax(arch):
    """``forward_embeds`` of the reduced backbone (deepseek: the dense
    layer, then the MoE layer) over 2 sequences of 40 tokens: within 1e-4
    of max |h| (grok's wq/wk drawn).  Every block is live: zeroing a
    layer's expert down-projection, or deepseek's dense layer's, moves h
    by more than ten bands."""
    jc, tc = _pair(arch)
    jb, tb = JBackbone(jc), TBackbone(tc)
    jp, tp = _params(jb.spec(), jc.d_model, seed=2)
    x = _x((2, 40, jc.d_model), 8)
    want = np.asarray(jb.forward_embeds(jp, jnp.asarray(x))[0])
    got = tb.forward_embeds(tp, torch.from_numpy(x))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale)
    cuts = [("blocks", "ffn", "w_down")]
    if tc.moe.first_k_dense:
        cuts.append(("dense_blocks", "ffn", "w_down"))
    for path in cuts:
        cut = tparams.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        leaf = cut
        for k in path[:-1]:
            leaf = leaf[k]
        leaf[path[-1]][0].zero_()
        moved = float((tb.forward_embeds(cut, torch.from_numpy(x))
                       - got).abs().max())
        assert moved > 10 * 1e-4 * scale, path


def _second_step_gap(arch, draw):
    """|grad norm| gap between the packages at the second ``flow_grpo``
    step, relative (the replay of ``test_moe_trainer_step_matches_jax``)."""
    from test_torch_trainers import _step_draws
    from torch_parity import normal, to_torch
    d_model = tconfigs.get_reduced(arch).d_model
    jtr, ttr = _trainer_pair("flow_grpo", arch=arch, draw=(
        (lambda t: _draw_qk(t, d_model, np.random.default_rng(5)))
        if draw else None))
    (cond,) = normal(8, (2, COND_LEN, 32))
    key = jax.random.PRNGKey(4)
    for it in range(2):
        draws = _step_draws(jtr, key, it, 2 * jtr.flow.group_size)
        jm = jax.device_get(jtr.step(jnp.asarray(cond), key, it=it))
        tm = ttr.step(to_torch(cond), 0, it=it, **draws)
    return abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_repository_init_and_the_attention(arch):
    """Why the parity checks redraw the attention's query and key
    projections.  grok (GQA): at the repository's init (fan-in from the
    head axis) the reduced backbone's f32 output differs between the
    packages by more than 1e-5 of max |h|, and by under 1e-5 once wq/wk
    are drawn at 1/sqrt(d_model), as for the dense family.  deepseek
    (MLA): the forward agrees within 1e-5 either way, but after one AdamW
    step from the repository's init the second step's grad norm differs by
    more than the replay's rtol 1e-4, and by under 1e-5 once w_uq/w_uk are
    drawn at 1/sqrt(rank)."""
    if arch == "grok-1-314b":
        jc, tc = _pair(arch)
        jb, tb = JBackbone(jc), TBackbone(tc)
        x = _x((2, 40, jc.d_model), 8)
        gaps = []
        for draw in (False, True):
            jp, tp = _params(jb.spec(), jc.d_model, seed=2, draw_qk=draw)
            want = np.asarray(jb.forward_embeds(jp, jnp.asarray(x))[0])
            got = tb.forward_embeds(tp, torch.from_numpy(x)).numpy()
            gaps.append(float(np.abs(got - want).max() / np.abs(want).max()))
        assert gaps[0] > 1e-5 and gaps[1] < 1e-5, gaps
    else:
        gaps = [_second_step_gap(arch, draw) for draw in (False, True)]
        assert gaps[0] > 1e-4 and gaps[1] < 1e-5, gaps


def _adapters(arch, num_steps=3):
    kw = dict(num_steps=num_steps, latent_tokens=LATENT_TOKENS,
              latent_dim=LATENT_DIM)
    jc, tc = _pair(arch)
    return (JFlowAdapter(jc, JFlowRLConfig(**kw), COND_DIM),
            TFlowAdapter(tc, TFlowRLConfig(**kw), COND_DIM))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_velocity_matches_jax(arch):
    """The causal velocity of the reduced arch over [cond (4); time token;
    latents (64)]: within 1e-4 of max |v|; the first latent's velocity does
    not depend on later latents (routing is per token, attention causal)."""
    ja, ta = _adapters(arch)
    jp, tp = _params(ja.spec(), ja.cfg.d_model, seed=3)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, LATENT_TOKENS, LATENT_DIM)).astype(np.float32)
    cond = rng.standard_normal((2, COND_LEN, COND_DIM)).astype(np.float32)
    t = np.array([0.9, 0.35], np.float32)
    want = np.asarray(ja.velocity(jp, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(cond)))
    got = ta.velocity(tp, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(cond))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    x2 = x.copy()
    x2[:, 1:] += 1.0
    got2 = ta.velocity(tp, torch.from_numpy(x2), torch.from_numpy(t),
                       torch.from_numpy(cond))
    scale = float(got.abs().max())
    assert float((got2[:, 0] - got[:, 0]).abs().max()) <= 1e-6 * scale
    assert float((got2[:, 1:] - got[:, 1:]).abs().max()) > 1e-2 * scale


def _jax_draws(ja, keys, num_steps):
    """The draws ``repro.core.rollout.rollout_keyed`` makes, recomputed as
    it makes them (test_torch_dense.py)."""
    shape = (LATENT_TOKENS, LATENT_DIM)
    k2 = jax.vmap(jax.random.split)(keys)
    k_init, k_step = k2[:, 0], k2[:, 1]
    x_init = jax.vmap(lambda k: ja.init_latent(k, 1)[0])(k_init)
    eps = jnp.stack([jax.vmap(lambda k: jax.random.normal(
        jax.random.fold_in(k, i), shape, jnp.float32))(k_step)
        for i in range(num_steps)])
    return np.asarray(x_init), np.asarray(eps)


@pytest.mark.parametrize("arch", ARCHS)
def test_rollout_keyed_matches_jax_on_replayed_draws(arch):
    """The serving path's rollout of the reduced arch, three flow_sde steps
    on the reference's per-request draws: latents 2e-4, log-densities rtol
    1e-5, as for the other families."""
    ja, ta = _adapters(arch)
    jp, tp = _params(ja.spec(), ja.cfg.d_model, seed=5)
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


# ------------------------------------------------------------- training
@pytest.mark.parametrize("name", ["flow_grpo", "nft"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_trainer_step_matches_jax(arch, name):
    """Two full ``step``s of ``flow_grpo`` (a loss backward per SDE step)
    and ``nft`` on the reduced arch, grok's wq/wk drawn, on the reference's
    draws (``_replay_two_steps``: reward, loss, grad norm and lr each step,
    the params after AdamW); every expert table and the router move."""
    d_model = tconfigs.get_reduced(arch).d_model
    jtr, ttr = _trainer_pair(name, arch=arch, draw=lambda tree: _draw_qk(
        tree, d_model, np.random.default_rng(5)))
    ffn = ttr.state.params["backbone"]["blocks"]["ffn"]
    before = {k: v.numpy().copy() for k, v in tparams.leaves(ffn)}
    _replay_two_steps(name, jtr, ttr, COND_LEN)
    lr = float(jtr.opt_cfg.lr)
    for k, b in before.items():
        moved = np.abs(dict(tparams.leaves(ffn))[k].numpy() - b).max()
        assert moved > lr / 10, k


BF16_ATOL = 0.02
TINY_FLOW = TFlowRLConfig(
    num_steps=4, group_size=4, latent_tokens=8, latent_dim=8, clip_range=0.2,
    rewards=(TSpec("text_render", 1.0,
                   args={"latent_dim": 8, "latent_tokens": 8}),
             TSpec("pickscore", 0.25, args={"latent_dim": 8})))
TINY_OPT = TOptim(lr=1e-3, total_steps=50, warmup_steps=2)
TINY_COND = torch.randn(2, 4, 512, generator=torch.Generator().manual_seed(7))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_block_equals_none_on_moe(arch):
    """``remat="block"`` (each dense and MoE block checkpointed: the
    routing, dispatch and experts recomputed in the backward) against
    ``"none"`` on one f32 trajectory: the loss within rtol 1e-5 / atol
    1e-6 and every gradient leaf within 1e-6 of its max |grad| (the
    recompute runs the same ops and routes the same way)."""
    def make(**perf):
        return tregistry.build("trainer", "flow_grpo",
                               tconfigs.get_reduced(arch), TINY_FLOW,
                               TINY_OPT, device="cpu", dtype=torch.float32,
                               perf=TPerf(**perf))
    base, blk = make(), make(remat="block")
    traj = base.sample(base.state.params, TINY_COND,
                       torch.Generator().manual_seed(0))
    _, adv, _ = base._rewards(traj.x0, {"cond": traj.cond})
    lb, _ = base.backward(traj, adv)
    lk, _ = blk.backward(traj, adv)
    np.testing.assert_allclose(float(lk), float(lb), rtol=1e-5, atol=1e-6)
    for (_, a), (_, b) in zip(tparams.leaves(base.state.params),
                              tparams.leaves(blk.state.params)):
        assert a.grad is not None and b.grad is not None
        np.testing.assert_allclose(
            b.grad.numpy(), a.grad.numpy(), rtol=0,
            atol=1e-6 * max(float(a.grad.abs().max()), 1e-30))


# ------------------------------------------------------------------ CLIs
TINY_ENCODER = {"cond_dim": 32, "cond_len": 4, "vocab": 256, "hidden": 64}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_moe_reduced_on_cpu(arch, tmp_path):
    """``launch.serve --arch <moe arch> --reduced`` on the CPU: 3 requests,
    finite latents."""
    out = tserve.main([
        "--arch", arch, "--reduced", "--device", "cpu", "--sde", "flow_sde",
        "--requests", "3", "--max-batch", "2",
        "--set", "flow.num_steps=2", "--set", "flow.latent_tokens=16",
        "--set", "flow.latent_dim=8",
        "--set", f"data.encoder={json.dumps(TINY_ENCODER)}",
        "--stats-json", str(tmp_path / "stats.json")])
    lat = out["latents"]
    assert tuple(lat.shape) == (3, 16, 8) and torch.isfinite(lat).all()
    assert out["engine"].adapter.cfg.family == "moe"
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["requests"] == 3 and stats["device"] == "cpu"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_runs_moe_reduced_under_block_on_cpu(arch, tmp_path):
    """``launch.train --arch <moe arch> --reduced --set perf.remat=block``
    on the CPU: 2 steps, finite metrics, the banner's parameter count the
    reference's."""
    out = ttrain.main([
        "--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
        "--set", "flow.num_steps=2", "--set", "flow.group_size=2",
        "--set", "flow.latent_tokens=16", "--set", "flow.latent_dim=8",
        "--set", f"data.encoder={json.dumps(TINY_ENCODER)}",
        "--set", "perf.remat=block",
        "--set", f"flow.cache_dir={tmp_path / 'cache'}",
        "--set", f"loop.ckpt_dir={tmp_path / 'ckpt'}"])
    hist = out["history"]
    assert len(hist) == 2
    assert all(np.isfinite(float(r["loss"])) for r in hist)
    assert out["experiment"].describe()["arch"]["n_params"] == \
        jregistry.build("arch", arch, reduced=True).n_params()


# ------------------------------------------------------------ multi-rank
@pytest.fixture(scope="module")
def moe_four_ranks(tmp_path_factory):
    import torch_dist_worker as worker
    return worker.spawn(4, "moe_four_ranks",
                        tmp_path_factory.mktemp("moe_four"), 240)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_two_axis_training_matches_single_device(moe_four_ranks, arch):
    """flow_grpo on the narrowed MoE arch (``torch_dist_worker.moe_arch``)
    at dp = 2 x mp = 2 on four gloo ranks, params and moments sharded over
    "model" (the expert tables by expert, MLA's up-projections by head),
    2 steps against one device, in the reference's band (rtol 1e-3, atol
    2e-4; ``test_torch_distributed._close``)."""
    from test_torch_distributed import _close
    h_ref, h, params_ref, params, rep = moe_four_ranks[arch]
    _close(h_ref, h, params_ref, params, f"{arch} dp2xmp2")
    assert rep["sharded_leaves"] > 0
    assert rep["per_device_bytes"] < 0.55 * rep["total_bytes"]
    experts = [k for k in params if k.endswith("ffn.w_gate")]
    assert experts


def test_moe_expert_chunks_do_not_change_the_result(monkeypatch):
    """The experts walked one at a time (``_CHUNK_ELEMS`` at its floor, as
    grok-1's width forces on the card) against all at once: output and
    every gradient within 1e-6 of their max (the same products, batched
    differently)."""
    jc, tc, _, tp = _moe_pair("deepseek-v2-236b", seed=7)
    x = torch.from_numpy(_x((2, 24, jc.d_model), 8))

    def run():
        leaves = {k: v.clone().requires_grad_()
                  for k, v in tparams.state_dict(tp).items()}
        tree = {"shared": {}}
        for k, v in leaves.items():
            if k.startswith("shared."):
                tree["shared"][k.split(".")[1]] = v
            else:
                tree[k] = v
        y, _ = tmoe.apply(tree, tc, x)
        (y * torch.linspace(-1, 1, y.shape[-1])).sum().backward()
        return y.detach(), {k: v.grad for k, v in leaves.items()}

    y1, g1 = run()
    monkeypatch.setattr(tmoe, "_CHUNK_ELEMS", 1)
    y2, g2 = run()
    np.testing.assert_allclose(y2.numpy(), y1.numpy(), rtol=0,
                               atol=1e-6 * float(y1.abs().max()))
    for k in g1:
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=0,
                                   atol=1e-6 * float(g1[k].abs().max()),
                                   err_msg=k)

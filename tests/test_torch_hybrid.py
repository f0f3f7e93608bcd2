"""Parity of the port's hybrid family (``zamba2-2.7b``: groups of Mamba-2
blocks, each followed by one *shared* attention + SwiGLU block) with the
JAX package, on the CPU.

The reduced ``zamba2-2.7b`` (2 groups of 1 SSM block, heads of 64): its
config, spec tree and parameter counts, the backbone forward and the
causal ``FlowAdapter.velocity`` on carried weights, replayed ``flow_grpo``
and ``nft`` steps, and ``remat="block"`` against ``"none"``.  A hybrid at
the full config's head dim of 80 (2 heads of 80, 2 groups of 2 SSM blocks)
holds the plain attention at D = 80 inside the backbone, and the plain
attention forward and backward at D = 80 alone are held against the
reference's interpret-mode Pallas kernel and ``jax.vjp`` of its jnp
``attention_chunked``.

Parameters are made by the JAX package and carried across with
``repro_torch.models.params.from_numpy``, SSM leaves drawn from Mamba-2's
init (at the repository's init the scan hardly moves a block); inputs are
made with numpy from a seed.  The kernels run their plain versions here
(``chip_smoke.py`` holds the D = 80 attention kernels against them on the
card).
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
from repro.config import ArchConfig as JArch
from repro.config import FlowRLConfig as JFlowRLConfig
from repro.config import HybridConfig as JHybrid
from repro.config import SSMConfig as JSSM
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import params as jparams
from repro.models.backbone import Backbone as JBackbone
from repro.models.flow import FlowAdapter as JFlowAdapter
from repro.models.layers import attention_chunked as jattention_chunked
from repro_torch import configs as tconfigs
from repro_torch import registry as tregistry
from repro_torch.config import ArchConfig as TArch
from repro_torch.config import FlowRLConfig as TFlowRLConfig
from repro_torch.config import HybridConfig as THybrid
from repro_torch.config import OptimConfig as TOptim
from repro_torch.config import PerfConfig as TPerf
from repro_torch.config import RewardSpec as TSpec
from repro_torch.config import SSMConfig as TSSM
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import params as tparams
from repro_torch.models.backbone import Backbone as TBackbone
from repro_torch.models.flow import FlowAdapter as TFlowAdapter

from test_torch_ssm import _band, _draw_ssm
from test_torch_trainers import _replay_two_steps, _trainer_pair
from test_torch_training import _np_tree
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "zamba2-2.7b"
LATENT_TOKENS, LATENT_DIM = 64, 16
COND_LEN, COND_DIM = 31, 32          # 31 + 1 + 64 = 96 = 3 chunks of 32
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


def _draw_qk(tree, d_model, rng):
    """The shared block's wq and wk redrawn at std 1/sqrt(d_model), in
    place.  The repository's init takes a 3-D projection's fan-in from its
    head axis, so the attention logits have std ≈ d_model / n_heads (64 in
    the reduced config): the softmax is nearly one-hot and amplifies the
    f32 rounding of its inputs (the scan's sums in another order) to 2e-4
    of max |h| (``test_repository_init_amplifies_the_shared_attention``),
    as for the dense family (test_torch_dense.py)."""
    if isinstance(tree, dict):
        if "shared_attn" in tree:
            attn = tree["shared_attn"]["attn"]
            for k in ("wq", "wk"):
                attn[k] = (rng.standard_normal(attn[k].shape) / d_model ** 0.5
                           ).astype(attn[k].dtype)
        for v in tree.values():
            _draw_qk(v, d_model, rng)
    return tree


def _params(spec, d_model, dtype="float32", seed=0, draw_qk=True):
    """JAX params with the SSM leaves drawn (and the shared block's wq/wk
    unless ``draw_qk`` is False), and the same tree on the port's CPU, bit
    for bit."""
    p = jparams.init(spec, jax.random.PRNGKey(seed), JAX_DT[dtype])
    tree = _draw_ssm(jax.tree.map(np.asarray, p),
                     np.random.default_rng(seed + 100))
    if draw_qk:
        tree = _draw_qk(tree, d_model, np.random.default_rng(seed + 200))
    return jax.tree.map(jnp.asarray, tree), tparams.from_numpy(tree, "cpu")


# ------------------------------------------------------------ config, spec
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_zamba2_config_spec_and_counts_match_jax(reduced):
    """The config field for field, the adapter's spec tree key for key
    (shape, logical axes, init: blocks stacked (groups, attn_every, ...)
    under "groups" with an unnamed inner axis, one unstacked shared block),
    and ``n_params`` / ``n_active_params`` equal to the reference's
    (2,422,100,928 at full size)."""
    get_j = jconfigs.get_reduced if reduced else jconfigs.get
    get_t = tconfigs.get_reduced if reduced else tconfigs.get
    jc, tc = get_j(ARCH), get_t(ARCH)
    jd = dataclasses.asdict(jc)
    for k, v in dataclasses.asdict(tc).items():
        assert jd[k] == v, k
    assert tc.family == "hybrid" and not tc.attn_free
    flow = dict(latent_tokens=64, latent_dim=16)
    jspec = JFlowAdapter(jc, JFlowRLConfig(**flow), 512).spec()
    tspec = TFlowAdapter(tc, TFlowRLConfig(**flow), 512).spec()
    assert _shapes(jspec) == _shapes(tspec)
    groups = tc.n_layers // tc.hybrid.attn_every
    in_proj = tspec["backbone"]["blocks"]["ssm"]["in_proj"]
    assert in_proj.shape[:2] == (groups, tc.hybrid.attn_every)
    assert in_proj.axes[:2] == ("groups", None)
    assert "wq" in tspec["backbone"]["shared_attn"]["attn"]
    assert tc.n_params() == jc.n_params()
    assert tc.n_active_params() == jc.n_active_params()
    if not reduced:
        assert (groups, tc.resolved_head_dim, tc.ssm.d_state) == (9, 80, 64)
        assert tc.n_params() == 2_422_100_928
    assert tregistry.build("arch", ARCH, reduced=reduced) == tc


# --------------------------------------------------------- the backbone
def _reduced_pair():
    return jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)


def test_hybrid_backbone_matches_jax():
    """``forward_embeds`` of the reduced backbone in f32 on carried weights
    (SSM leaves and the shared wq/wk drawn): 1e-4 of max |h|.  Both kinds
    of block are live: zeroing the shared block's output projection, or one
    group's SSM output projection, moves h by more than ten bands."""
    jc, tc = _reduced_pair()
    jb, tb = JBackbone(jc), TBackbone(tc)
    jp, tp = _params(jb.spec(), jc.d_model, seed=2)
    (x,) = [np.random.default_rng(8).standard_normal(
        (2, 96, jc.d_model)).astype(np.float32)]
    want, _, _ = jb.forward_embeds(jp, jnp.asarray(x))
    got = tb.forward_embeds(tp, torch.from_numpy(x))
    _band(got, want, "float32")
    scale = float(np.abs(np.asarray(want)).max())
    for path in (("shared_attn", "attn", "wo"), ("blocks", "ssm", "out_proj")):
        cut = tparams.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        leaf = cut
        for k in path[:-1]:
            leaf = leaf[k]
        if path[0] == "blocks":
            leaf[path[-1]][0].zero_()
        else:
            leaf[path[-1]].zero_()
        moved = float((tb.forward_embeds(cut, torch.from_numpy(x))
                       - got).abs().max())
        assert moved > 10 * 1e-4 * scale, path


def test_repository_init_amplifies_the_shared_attention():
    """Why the parity checks draw the shared wq/wk: at the repository's
    init the reduced backbone's f32 output differs between the packages by
    more than 1e-4 of max |h| (the one-hot softmax amplifies the scan's
    rounding), and by under 1e-5 once wq/wk are drawn at
    1/sqrt(d_model)."""
    jc, tc = _reduced_pair()
    jb, tb = JBackbone(jc), TBackbone(tc)
    (x,) = [np.random.default_rng(8).standard_normal(
        (2, 96, jc.d_model)).astype(np.float32)]
    gaps = []
    for draw in (False, True):
        jp, tp = _params(jb.spec(), jc.d_model, seed=2, draw_qk=draw)
        want = np.asarray(jb.forward_embeds(jp, jnp.asarray(x))[0])
        got = tb.forward_embeds(tp, torch.from_numpy(x)).numpy()
        gaps.append(float(np.abs(got - want).max() / np.abs(want).max()))
    assert gaps[0] > 1e-4 and gaps[1] < 1e-5, gaps


def _velocity_inputs(seed=0, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, LATENT_TOKENS, LATENT_DIM)).astype(
        np.float32)
    cond = rng.standard_normal((B, COND_LEN, COND_DIM)).astype(np.float32)
    return x, np.array([0.9, 0.35][:B], np.float32), cond


def test_hybrid_velocity_matches_jax():
    """The causal velocity of the reduced zamba2-2.7b over [cond (31);
    time token; latents (64)] in f32: 1e-4 of max |v|; the first latent's
    velocity does not depend on later latents."""
    jc, tc = _reduced_pair()
    kw = dict(latent_tokens=LATENT_TOKENS, latent_dim=LATENT_DIM)
    ja = JFlowAdapter(jc, JFlowRLConfig(**kw), COND_DIM)
    ta = TFlowAdapter(tc, TFlowRLConfig(**kw), COND_DIM)
    jp, tp = _params(ja.spec(), jc.d_model, seed=3)
    x, t, cond = _velocity_inputs()
    want = ja.velocity(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    got = ta.velocity(tp, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(cond))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, LATENT_TOKENS, LATENT_DIM)
    _band(got, want, "float32")
    x2 = x.copy()
    x2[:, 1:] += 1.0
    got2 = ta.velocity(tp, torch.from_numpy(x2), torch.from_numpy(t),
                       torch.from_numpy(cond))
    scale = float(got.abs().max())
    assert float((got2[:, 0] - got[:, 0]).abs().max()) <= 1e-6 * scale
    assert float((got2[:, 1:] - got[:, 1:]).abs().max()) > 1e-2 * scale


# ------------------------------------------------- a hybrid at head dim 80
def _d80(cls_arch, cls_ssm, cls_hybrid):
    return cls_arch(
        name="hybrid-d80", family="hybrid", n_layers=4, d_model=160,
        n_heads=2, n_kv_heads=2, d_ff=320, vocab_size=64, head_dim=80,
        ssm=cls_ssm(d_state=16, expand=2, head_dim=32, chunk=8, d_conv=4),
        hybrid=cls_hybrid(attn_every=2, shared_attn=True))


def test_head_dim_80_hybrid_backbone_matches_jax():
    """A hybrid at the full config's head dim (2 heads of 80, 2 groups of 2
    SSM blocks, state 16, chunk 8) over 24 tokens in f32: the backbone on
    carried weights within 1e-4 of max |h|, the shared attention through
    the plain attention at D = 80."""
    jc, tc = _d80(JArch, JSSM, JHybrid), _d80(TArch, TSSM, THybrid)
    jb, tb = JBackbone(jc), TBackbone(tc)
    assert _shapes(jb.spec()) == _shapes(tb.spec())
    assert tc.n_params() == jc.n_params()
    jp, tp = _params(jb.spec(), jc.d_model, seed=4)
    assert tuple(tp["shared_attn"]["attn"]["wq"].shape)[-1] == 80
    (x,) = [np.random.default_rng(9).standard_normal(
        (2, 24, jc.d_model)).astype(np.float32)]
    want, _, _ = jb.forward_embeds(jp, jnp.asarray(x))
    got = tb.forward_embeds(tp, torch.from_numpy(x))
    _band(got, want, "float32")


# --------------------------------------------- the attention at head dim 80
D80_CASES = [  # B, Sq, H, K, causal, window
    (2, 128, 4, 2, True, 0),
    (1, 96, 2, 2, True, 32),
    (1, 77, 4, 2, True, 0),
]


def _qkv(B, S, H, K, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, 80), (B, S, K, 80), (B, S, K, 80),
                      (B, S, H, 80))]


@pytest.mark.parametrize("B,S,H,K,causal,window", D80_CASES,
                         ids=["causal", "window", "ragged"])
def test_attention_d80_forward_matches_pallas_and_chunked(B, S, H, K, causal,
                                                          window):
    """The port's plain attention at D = 80 (scale 80^-1/2) against the
    reference's Pallas kernel in interpret mode (64-row blocks; the ragged
    77 in one block) and its jnp ``attention_chunked``, f32: 2e-5, the
    tolerance of tests/test_kernels.py (online softmax over key blocks
    against one softmax)."""
    qn, kn, vn, _ = _qkv(B, S, H, K, S + H)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (qn, kn, vn)),
                              causal=causal, window=window)
    assert tuple(out.shape) == (B, S, H, 80)
    blk = 64 if S % 64 == 0 else S
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    for want in (jflash(jq, jk, jv, causal=causal, window=window,
                        block_q=blk, block_k=blk, interpret=True),
                 jattention_chunked(jq, jk, jv, causal=causal,
                                    window=window, chunk_q=32)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("B,S,H,K,causal,window", D80_CASES,
                         ids=["causal", "window", "ragged"])
def test_attention_d80_backward_matches_jax_vjp(B, S, H, K, causal, window):
    """The plain backward at D = 80 (``ref.flash_attention_bwd_ref`` from
    the forward's o and log-sum-exp) and the autograd Function on CPU
    tensors against ``jax.vjp`` of the reference's ``attention_chunked``,
    f32: each of dq, dk, dv within 1e-5 of its max |reference| (sums in
    another order; dk and dv summed over each GQA group)."""
    qn, kn, vn, gn = _qkv(B, S, H, K, 3 * S + H)
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


# ------------------------------------------------------------- training
@pytest.mark.parametrize("name", ["flow_grpo", "nft"])
def test_hybrid_trainer_step_matches_jax(name):
    """Two full ``step``s of ``flow_grpo`` (a loss backward per SDE step)
    and ``nft`` on the reduced zamba2-2.7b, SSM leaves and the shared wq/wk
    drawn, on the reference's draws, f32 (``_replay_two_steps``: reward,
    loss, grad norm and lr each step, the params after AdamW).  The shared
    block's gradient is the sum over its two sites: each of its leaves
    moved, and, leaf by leaf, its AdamW moves agree with the reference's as
    the whole tree's do (within lr / 10 but for under 1e-3 of the entries,
    near-zero gradients whose sign differs, and never 4 lr apart)."""
    d_model = tconfigs.get_reduced(ARCH).d_model
    jtr, ttr = _trainer_pair(name, arch=ARCH, draw=lambda tree: _draw_qk(
        tree, d_model, np.random.default_rng(5)))
    shared = ttr.state.params["backbone"]["shared_attn"]
    before = {k: v.numpy().copy() for k, v in tparams.leaves(shared)}
    _replay_two_steps(name, jtr, ttr, COND_LEN)
    jshared = dict(tparams.leaves(
        _np_tree(jtr.state.params)["backbone"]["shared_attn"]))
    lr = float(jtr.opt_cfg.lr)
    for k, b in before.items():
        got = dict(tparams.leaves(shared))[k].numpy()
        assert np.abs(jshared[k] - b).max() > lr / 10, k
        gap = np.abs(got - jshared[k])
        assert gap.max() <= 4 * lr and np.mean(gap > lr / 10) < 1e-3, k


# the reference's bf16 band (tests/test_torch_perf.py): one ulp at |w|~0.25
# is ~2e-3, and AdamW's rsqrt amplifies single-ulp gradient noise
BF16_ATOL = 0.02
TINY_FLOW = TFlowRLConfig(
    num_steps=4, group_size=4, latent_tokens=8, latent_dim=8, clip_range=0.2,
    rewards=(TSpec("text_render", 1.0,
                   args={"latent_dim": 8, "latent_tokens": 8}),
             TSpec("pickscore", 0.25, args={"latent_dim": 8})))
TINY_OPT = TOptim(lr=1e-3, total_steps=50, warmup_steps=2)
TINY_COND = torch.randn(2, 4, 512, generator=torch.Generator().manual_seed(7))


def _make(dtype, **perf):
    return tregistry.build("trainer", "flow_grpo", tconfigs.get_reduced(ARCH),
                           TINY_FLOW, TINY_OPT, device="cpu", dtype=dtype,
                           perf=TPerf(**perf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_block_equals_none_on_the_hybrid(dtype):
    """``remat="block"`` (each group checkpointed, the shared block
    recomputed at every site) against ``"none"`` on one trajectory: the
    loss within the reference's rtol 1e-5 / atol 1e-6, and in f32 every
    gradient leaf within 1e-6 of max |grad| (the recompute runs the same
    ops); then two steps each, the params within the bf16 band of the
    dense family's test (0.02)."""
    base, blk = _make(TORCH_DT[dtype]), _make(TORCH_DT[dtype], remat="block")
    traj = base.sample(base.state.params, TINY_COND,
                       torch.Generator().manual_seed(0))
    _, adv, _ = base._rewards(traj.x0, {"cond": traj.cond})
    lb, _ = base.backward(traj, adv)
    lk, _ = blk.backward(traj, adv)
    np.testing.assert_allclose(float(lk), float(lb), rtol=1e-5, atol=1e-6)
    for (_, a), (_, b) in zip(tparams.leaves(base.state.params),
                              tparams.leaves(blk.state.params)):
        assert a.grad is not None and b.grad is not None
        if dtype == "float32":
            np.testing.assert_allclose(
                b.grad.numpy(), a.grad.numpy(), rtol=0,
                atol=1e-6 * max(float(a.grad.abs().max()), 1e-30))
    for tr in (base, blk):
        for _, p in tparams.leaves(tr.state.params):
            p.grad = None
    for tr in (base, blk):
        for it in range(2):
            tr.step(TINY_COND, 0, it=it)
    for (_, a), (_, b) in zip(tparams.leaves(base.state.params),
                              tparams.leaves(blk.state.params)):
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   rtol=BF16_ATOL, atol=BF16_ATOL)


# ------------------------------------------------------------------ CLIs
TINY_ENCODER = {"cond_dim": 32, "cond_len": 31, "vocab": 256, "hidden": 64}


def test_serve_cli_runs_zamba2_reduced_on_cpu(tmp_path):
    """``launch.serve --arch zamba2-2.7b --reduced`` on the CPU: 3 requests
    over 31 + 1 + 32 tokens (two chunks of 32), finite latents."""
    out = tserve.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--sde", "flow_sde",
        "--requests", "3", "--max-batch", "2",
        "--set", "flow.num_steps=2", "--set", "flow.latent_tokens=32",
        "--set", "flow.latent_dim=8",
        "--set", f"data.encoder={json.dumps(TINY_ENCODER)}",
        "--stats-json", str(tmp_path / "stats.json")])
    lat = out["latents"]
    assert tuple(lat.shape) == (3, 32, 8) and torch.isfinite(lat).all()
    assert out["engine"].adapter.cfg.family == "hybrid"
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["requests"] == 3 and stats["device"] == "cpu"


def test_train_cli_runs_zamba2_reduced_under_block_on_cpu(tmp_path):
    """``launch.train --arch zamba2-2.7b --reduced --set perf.remat=block``
    on the CPU: 2 steps, finite metrics, the banner's parameter count the
    reference's."""
    out = ttrain.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
        "--set", "flow.num_steps=2", "--set", "flow.group_size=2",
        "--set", "flow.latent_tokens=32", "--set", "flow.latent_dim=8",
        "--set", f"data.encoder={json.dumps(TINY_ENCODER)}",
        "--set", "perf.remat=block",
        "--set", f"flow.cache_dir={tmp_path / 'cache'}",
        "--set", f"loop.ckpt_dir={tmp_path / 'ckpt'}"])
    hist = out["history"]
    assert len(hist) == 2
    assert all(np.isfinite(float(r["loss"])) for r in hist)
    assert out["experiment"].describe()["arch"]["n_params"] == \
        tconfigs.get_reduced(ARCH).n_params()
    assert jregistry.build("arch", ARCH, reduced=True).n_params() == \
        tconfigs.get_reduced(ARCH).n_params()

"""Parity of the port's LM task path (``repro_torch.models.tasks``) with the
JAX package, on the CPU, for every arch the reference registers: the
reference's ``tests/test_archs_smoke.py`` on the port (train step, prefill
and decode shapes, reduced bounds, full config values), each step held
against the reference's on the same parameters and batch, the reference's
``test_decode_consistent_with_forward`` for all eleven archs, the chunked
cross-entropy, the caches' layout (MLA's rank-compressed), the shape
policy over every arch x input shape and ``TokenStream``.

Parameters are made by the JAX package (``tasks.init_params`` on a PRNG
key) and carried across with ``repro_torch.models.params.from_numpy``;
batches are made with numpy from a seed and fed to both packages.  The
attention and the scan run their plain versions here (``chip_smoke.py``
holds the kernels against them on the card).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.config import INPUT_SHAPES as J_INPUT_SHAPES
from repro.config import OptimConfig as JOptim
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import tasks as jtasks
from repro.models.backbone import Backbone as JBackbone
from repro.models import attention as jattention
from repro.models.layers import chunked_ce_loss as jchunked_ce_loss
from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.config import INPUT_SHAPES, OptimConfig
from repro_torch.data import TokenStream
from repro_torch.models import attention as tattention
from repro_torch.models import params as tparams
from repro_torch.models import tasks
from repro_torch.models.backbone import Backbone
from repro_torch.models.layers import chunked_ce_loss

from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ALL_ARCHS = tconfigs.ARCH_IDS + tconfigs.PAPER_ARCHS
B, S = 2, 32
OPT = dict(lr=0.01, total_steps=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair_params(arch, dtype=jnp.float32, seed=0):
    """The reference's reduced ``arch`` params (JAX) and the same tree on
    the port's CPU."""
    cfg = jconfigs.get_reduced(arch)
    jp = jtasks.init_params(cfg, jax.random.PRNGKey(seed), dtype)
    tree = _np_tree(jp)
    return jp, tasks.init_params(tconfigs.get_reduced(arch), dtype=None,
                                 device="cpu", arrays=tree)


def _batches(arch, batch=B, seq=S, seed=1):
    """One numpy batch as each package takes it: tokens (int32), labels
    (tokens rolled left), and for a frontend arch the prefix embeddings
    (f32 normals in bf16)."""
    tcfg = tconfigs.get_reduced(arch)
    tb = tasks.synthetic_batch(tcfg, batch, seq, seed, "cpu")
    jb = {"tokens": jnp.asarray(tb["tokens"].numpy()),
          "labels": jnp.asarray(tb["labels"].numpy())}
    if "prefix_embed" in tb:
        jb["prefix_embed"] = jnp.asarray(
            tb["prefix_embed"].float().numpy()).astype(jnp.bfloat16)
    return jb, tb


def _cache_leaves(tree):
    """The tensors of a cache tree in ``jax.tree.leaves`` order
    (NamedTuple fields and tuple items in order)."""
    if isinstance(tree, tuple):
        return [t for v in tree for t in _cache_leaves(v)]
    return [tree]


def _close(got, want, rel, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


# ------------------------------------------------------------- train step
def _jax_loss(cfg):
    """The reference train step's differentiated loss
    (``repro/models/tasks.py:84-95``, a closure there): CE over the
    tokens after the frontend prefix plus the MoE auxiliary losses."""
    model = JBackbone(cfg)
    n_pre = model.n_prefix

    def loss_fn(p, batch):
        x = model.embed_inputs(p, batch["tokens"], batch.get("prefix_embed"))
        hidden, _, aux = model.forward_embeds(p, x, causal=True, remat=True)
        if n_pre:
            hidden = hidden[:, n_pre:]
        ce = jchunked_ce_loss(hidden, model.head_matrix(p), batch["labels"])
        return ce + sum(aux.values()) if aux else ce

    return loss_fn


# each leaf's gradient against jax.grad's, to this share of the leaf's own
# max |gradient| (measured <= 1.3e-3, zamba2's embed and in_proj)
LEAF_GRAD_BAND = 3e-3


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_matches_jax(arch):
    """The reference's ``test_train_step`` on the port (finite loss and
    grad norm, params that move), and one step held against the
    reference's on the same f32 params and batch: every leaf's gradient
    (``torch.autograd.grad`` of the step's ``loss_fn``) against
    ``jax.grad`` of the reference's loss to ``LEAF_GRAD_BAND`` of that
    leaf's max (a leaf with no gradient in one package has exact zeros in
    the other); loss, ce and every auxiliary loss to 1e-5 of max(1, |x|)
    (chunked CE over 512 vocabulary columns and 2 x 32 tokens, f32 sums in
    another order), the gradient norm to rtol 2e-3, lr exactly, and the
    params after AdamW: the first step moves each param by ~lr *
    sign(grad), so they agree to lr / 10 where the two gradients share
    their sign (all but 1e-3 of the entries, a few near-zero gradients)
    and differ by at most 2 lr anywhere.  The gradient bands: at the
    repository's init the reduced LMs are badly conditioned (gradient
    norms in the hundreds), and both packages' f32 gradients lie ~1e-3 of
    their max from an f64 run of the port (zamba2's conv_w: JAX 7.3e-4,
    the port 9.4e-4); measured <= 7e-4 on the norm."""
    jp, tp = _pair_params(arch)
    jb, tb = _batches(arch)
    jcfg = jconfigs.get_reduced(arch)
    jstep = jax.jit(jtasks.make_train_step(jcfg, JOptim(**OPT)))
    jst, jm = jstep(jtasks.TrainState(jp, joptim.adamw_init(jp)), jb)
    jgrads = dict(tparams.leaves(_np_tree(
        jax.jit(jax.grad(_jax_loss(jcfg)))(jp, jb))))
    before = {k: v.clone() for k, v in tparams.state_dict(tp).items()}
    step = tasks.make_train_step(tconfigs.get_reduced(arch),
                                 OptimConfig(**OPT))
    leaves = list(tparams.leaves(tp))
    for _, t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(step.loss_fn(tp, tb)[0],
                                [t for _, t in leaves], allow_unused=True)
    for _, t in leaves:
        t.requires_grad_(False)
    assert set(jgrads) == {path for path, _ in leaves}
    for (path, t), g in zip(leaves, grads):
        want = jgrads[path]
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=LEAF_GRAD_BAND * float(np.abs(want).max()),
            err_msg=f"gradient of {'.'.join(path)}")
    st, m = step(tasks.TrainState(tp, toptim.adamw_init(tp)), tb)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert st.params is tp and int(st.opt.step) == 1
    assert set(m) == set(jm)
    assert max(float((v - before[k]).abs().max())
               for k, v in tparams.state_dict(st.params).items()) > 0
    for k in m:
        if k == "grad_norm":
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-3)
        elif k == "lr":
            assert float(m[k]) == float(jm[k])
        else:
            _close(float(m[k]), float(jm[k]), 1e-5, k)
    lr = float(m["lr"])
    jsd = dict(tparams.leaves(_np_tree(jst.params)))
    flat = np.concatenate([np.abs(t.numpy() - jsd[path]).ravel()
                           for path, t in tparams.leaves(st.params)])
    assert flat.max() <= 2 * lr * (1 + 1e-3)
    assert np.mean(flat > lr / 10) < 1e-3


def test_train_step_learns_on_token_stream():
    """Three steps of the reduced internvl2-1b on ``TokenStream`` batches
    (a learnable Markov source, the vision prefix drawn): CE falls."""
    cfg = tconfigs.get_reduced("internvl2-1b")
    p = tasks.init_params(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    step = tasks.make_train_step(cfg, OptimConfig(lr=3e-3, warmup_steps=1,
                                                  total_steps=10))
    st = tasks.TrainState(p, toptim.adamw_init(p))
    stream = TokenStream(cfg.vocab_size, 4, 32, seed=0).batches()
    fe = cfg.frontend
    pe = np.random.default_rng(2).standard_normal(
        (4, fe.n_tokens, fe.embed_dim)).astype(np.float32)
    ces = []
    for _ in range(3):
        nb = next(stream)
        b = tasks.synthetic_batch(cfg, 4, 32, device="cpu",
                                  tokens=nb["tokens"], prefix_embed=pe)
        b["labels"] = torch.from_numpy(nb["labels"])
        st, m = step(st, b)
        ces.append(float(m["ce"]))
    assert ces[-1] < ces[0], ces


# ------------------------------------------------------ prefill and decode
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_decode_matches_jax(arch):
    """The reference's ``test_prefill_decode_shapes`` on the port (bf16
    params: logits (B, V), finite, after prefill and after one decode), and
    in f32 on the same params and batch the prefill's last logits, every
    cache leaf (KV, MLA latent and rope key, SSM conv window and state),
    the decode's logits and rolled caches, each to 1e-4 of max(1, max |x|)
    of the reference's (f32 attention, scan and recurrence in another
    order)."""
    tcfg = tconfigs.get_reduced(arch)
    # the reference's smoke test, bf16
    p16 = tasks.init_params(tcfg, torch.Generator().manual_seed(0),
                            torch.bfloat16, "cpu")
    _, tb = _batches(arch)
    pre = {k: v for k, v in tb.items() if k != "labels"}
    logits, caches = tasks.make_prefill_step(tcfg)(p16, pre)
    assert tuple(logits.shape) == (B, tcfg.vocab_size)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    logits2, _ = tasks.make_decode_step(tcfg)(p16, caches, tok, S)
    assert tuple(logits2.shape) == (B, tcfg.vocab_size)
    assert torch.isfinite(logits2).all()

    # against the reference, f32
    jcfg = jconfigs.get_reduced(arch)
    jp, tp = _pair_params(arch, seed=3)
    jb, tb = _batches(arch, seed=4)
    jb.pop("labels")
    tb.pop("labels")
    jl, jc = jax.jit(jtasks.make_prefill_step(jcfg))(jp, jb)
    tl, tc = tasks.make_prefill_step(tcfg)(tp, tb)
    _close(tl.numpy(), jl, 1e-4, "prefill logits")
    jleaves, tleaves = jax.tree.leaves(jc), _cache_leaves(tc)
    assert len(jleaves) == len(tleaves)
    for i, (t, j) in enumerate(zip(tleaves, jleaves)):
        _close(t.numpy(), j, 1e-4, f"prefill cache leaf {i}")
    tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
    pos = S + tcfg.frontend.n_tokens
    jl2, jc2 = jax.jit(jtasks.make_decode_step(jcfg))(
        jp, jc, jnp.asarray(tok), jnp.int32(pos))
    tl2, tc2 = tasks.make_decode_step(tcfg)(tp, tc, torch.from_numpy(tok),
                                            pos)
    assert tc2 is tc            # written in place
    _close(tl2.numpy(), jl2, 1e-4, "decode logits")
    for i, (t, j) in enumerate(zip(_cache_leaves(tc2), jax.tree.leaves(jc2))):
        _close(t.numpy(), j, 1e-4, f"decode cache leaf {i}")


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_consistent_with_forward(arch):
    """prefill(x[:S]) + decode(x[S]) == forward(x[:S+1]) last logits (the
    reference's test, its seven archs and musicgen-large, yi-9b, yi-34b
    and flux_dit), f32 at the reference's band (2e-2) and within 1e-4
    absolute.
    One decode: the cache rolls, so only the first decode after a prefill
    sees every earlier token."""
    cfg = tconfigs.get_reduced(arch)
    p = tasks.init_params(cfg, torch.Generator().manual_seed(7),
                          torch.float32, "cpu")
    T = 24
    batch = tasks.synthetic_batch(cfg, 2, T + 1, 5, "cpu")
    toks = batch["tokens"]
    pre = {"tokens": toks[:, :T]}
    if "prefix_embed" in batch:
        pre["prefix_embed"] = batch["prefix_embed"]
    _, caches = tasks.make_prefill_step(cfg)(p, pre)
    # the new token's absolute position includes any frontend prefix
    pos = T + cfg.frontend.n_tokens
    logits_dec, _ = tasks.make_decode_step(cfg)(p, caches, toks[:, T:T + 1],
                                                pos)
    model = Backbone(cfg)
    x = model.embed_inputs(p, toks, batch.get("prefix_embed"))
    hidden = model.forward_embeds(p, x, causal=True)
    logits_full = model.logits(p, hidden[:, -1])
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(),
                               atol=2e-2, rtol=2e-2)
    assert float((logits_dec - logits_full).abs().max()) < 1e-4


@pytest.mark.parametrize("arch,n_pre,n_dec", [("mamba2-370m", 32, 32),
                                               ("zamba2-2.7b", 31, 1)])
def test_ssm_decode_is_exact_over_many_steps(arch, n_pre, n_dec):
    """The SSM recurrence has no roll: a prefill, then ``n_dec`` decodes,
    equals the forward over ``n_pre + n_dec`` tokens at every decoded
    position, to 1e-4 of max |logits|, f32.  The scan takes whole chunks of
    32 (or less than one): mamba2 prefills one chunk and decodes a second
    one token at a time; zamba2's shared attention cache rolls, so it
    prefills 31 and decodes 1 against the forward over one chunk."""
    cfg = tconfigs.get_reduced(arch)
    p = tasks.init_params(cfg, torch.Generator().manual_seed(2),
                          torch.float32, "cpu")
    toks = tasks.synthetic_batch(cfg, 2, n_pre + n_dec, 6, "cpu")["tokens"]
    _, caches = tasks.make_prefill_step(cfg)(p, {"tokens": toks[:, :n_pre]})
    dec = tasks.make_decode_step(cfg)
    got = []
    for i in range(n_pre, n_pre + n_dec):
        lg, caches = dec(p, caches, toks[:, i:i + 1], i)
        got.append(lg)
    model = Backbone(cfg)
    hidden = model.forward_embeds(p, model.embed_inputs(p, toks))
    want = model.logits(p, hidden[:, n_pre:])
    got = torch.stack(got, 1)
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


# ------------------------------------------------------------- the caches
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_and_init_caches_match_jax(arch):
    """``cache_specs`` equals the reference's leaf for leaf (shape and
    logical axes, the hybrid's and MoE family's pairs included);
    ``init_caches`` gives zeros of those shapes, the SSM state in f32."""
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    is_leaf = (lambda x: isinstance(x, tuple) and len(x) == 2
               and isinstance(x[0], tuple)
               and all(isinstance(d, int) for d in x[0]))
    jspec = jax.tree.leaves(JBackbone(jcfg).cache_specs(2, 40),
                            is_leaf=is_leaf)
    tspec = Backbone(tcfg).cache_specs(2, 40)
    from repro_torch.models.backbone import map_cache_spec
    flat = []
    map_cache_spec(lambda leaf, name: flat.append((leaf, name)), tspec)
    assert [leaf for leaf, _ in flat] == [tuple(x) for x in jspec]
    caches = tasks.init_caches(tcfg, 2, 40, torch.bfloat16, "cpu")
    for t, (leaf, name) in zip(_cache_leaves(caches), flat):
        assert tuple(t.shape) == leaf[0] and not t.any()
        assert t.dtype == (torch.float32 if name == "state"
                           else torch.bfloat16)


def test_mla_cache_is_rank_compressed():
    cfg = tconfigs.get_reduced("deepseek-v2-236b")
    shapes = []
    from repro_torch.models.backbone import map_cache_spec
    map_cache_spec(lambda leaf, name: shapes.append(leaf[0]),
                   Backbone(cfg).cache_specs(batch=2, cache_len=64))
    # MLA caches store (..., T, rank) latents, never (..., T, H, hd)
    assert shapes
    assert any(s[-1] == cfg.mla.kv_lora_rank for s in shapes)
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    assert not any(s[-2:] == (H, hd) for s in shapes)


@pytest.mark.parametrize("H,K,dt", [(4, 2, np.float32), (7, 1, np.float32),
                                    (4, 4, "bfloat16")])
def test_attention_decode_matches_jax(H, K, dt):
    """``attention.apply_decode`` (the port's one decode attention: the
    reference's ``layers.attention_decode`` and its roll of the cache):
    one token (GQA groups of 2, 7 and 1, q/k norms and RoPE at position
    40) over a 40-entry cache, against the reference's ``apply_decode`` on
    the same params, input and cache: the output and both rolled caches to
    1e-6 of their max in f32 and 1e-2 in bf16 (p and o rounded to bf16 in
    both, f32 sums in another order)."""
    rng = np.random.default_rng(H * 10 + K)
    B, T, D = 2, 40, 16
    kw = dict(n_heads=H, n_kv_heads=K, head_dim=D)
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen3-32b"), **kw)
    tcfg = dataclasses.replace(tconfigs.get_reduced("qwen3-32b"), **kw)
    d = jcfg.d_model
    tree = {name: (rng.standard_normal(leaf.shape) / np.sqrt(
        d if leaf.shape[0] == d else H * D) if name.startswith("w")
        else 1 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        for name, leaf in tattention.spec(tcfg).items()}
    x = rng.standard_normal((B, 1, d)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, T, K, D)).astype(np.float32)
              for _ in range(2))
    jdt = jnp.float32 if dt == np.float32 else jnp.bfloat16
    tdt = torch.float32 if dt == np.float32 else torch.bfloat16
    jo, jc = jattention.apply_decode(
        {k: jnp.asarray(v).astype(jdt) for k, v in tree.items()}, jcfg,
        jnp.asarray(x).astype(jdt),
        jattention.KVCache(*(jnp.asarray(a).astype(jdt) for a in (kc, vc))),
        jnp.int32(T))
    tc = tattention.KVCache(*(torch.from_numpy(a).to(tdt) for a in (kc, vc)))
    to, tc2 = tattention.apply_decode(
        tparams.from_numpy(tree, "cpu", tdt), tcfg,
        torch.from_numpy(x).to(tdt), tc, T)
    assert tuple(to.shape) == (B, 1, d) and to.dtype == tdt
    rel = 1e-6 if dt == np.float32 else 1e-2
    for got, want, what in ((to, jo, "o"), (tc2.k, jc.k, "k cache"),
                            (tc2.v, jc.v, "v cache")):
        want = np.asarray(want.astype(jnp.float32))
        assert tuple(got.shape) == want.shape, what
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=rel * np.abs(want).max(),
                                   err_msg=what)


# ------------------------------------------------------ chunked cross-entropy
@pytest.mark.parametrize("chunk", [16, 20, 48, 512])
def test_chunked_ce_matches_direct_and_jax(chunk):
    """The reference's test (chunk 16; 20 leaves a ragged tail of 8) and
    the whole sequence in one chunk: against the direct f32 CE to rtol
    1e-5, against the reference's ``chunked_ce_loss`` to rtol 1e-6, and
    its gradients in h and w against ``jax.grad`` to 1e-5 of their max."""
    Bc, Sc, d, V = 2, 48, 16, 64
    rng = np.random.default_rng(7)
    h = rng.standard_normal((Bc, Sc, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.1).astype(np.float32)
    y = rng.integers(0, V, (Bc, Sc)).astype(np.int32)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = chunked_ce_loss(th, tw, torch.from_numpy(y), chunk=chunk)
    logits = h @ w
    m = logits.max(-1, keepdims=True)
    logz = np.log(np.exp(logits - m).sum(-1)) + m[..., 0]
    want = (logz - np.take_along_axis(logits, y[..., None], -1)[..., 0]
            ).mean()
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)
    jwant = jchunked_ce_loss(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y),
                             chunk=chunk)
    np.testing.assert_allclose(float(got.detach()), float(jwant), rtol=1e-6)
    got.backward()
    jgh, jgw = jax.grad(lambda a, b: jchunked_ce_loss(
        a, b, jnp.asarray(y), chunk=chunk), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    for g, jg in ((th.grad, jgh), (tw.grad, jgw)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-5 * float(np.abs(jg).max()))


# ------------------------------------------------------- configs and shapes
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_reduced_config_bounds(arch):
    """The reference's contract: reduced = ≤2 layers, d_model ≤ 512, ≤4
    experts; and every reduced config is the reference's field for
    field."""
    cfg = tconfigs.get_reduced(arch)
    assert cfg.n_layers <= 2
    assert cfg.d_model <= 512
    if cfg.moe:
        assert cfg.moe.n_experts <= 4
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfigs.get_reduced(arch))


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_full_config_matches_assignment(arch):
    """The reference's table of assigned hyper-parameters, and every full
    config the reference's field for field with the same analytic
    counts."""
    cfg = tconfigs.get(arch)
    expected = {
        "zamba2-2.7b": (54, 2560, 32, 32, 10240, 32000),
        "grok-1-314b": (64, 6144, 48, 8, 32768, 131072),
        "yi-34b": (60, 7168, 56, 8, 20480, 64000),
        "internvl2-1b": (24, 896, 14, 2, 4864, 151655),
        "deepseek-v2-236b": (60, 5120, 128, 128, 12288, 102400),
        "smollm-360m": (32, 960, 15, 5, 2560, 49152),
        "qwen3-32b": (64, 5120, 64, 8, 25600, 151936),
        "yi-9b": (48, 4096, 32, 4, 11008, 64000),
        "mamba2-370m": (48, 1024, 0, 0, 0, 50280),
        "musicgen-large": (48, 2048, 32, 32, 8192, 2048),
    }[arch]
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.d_ff, cfg.vocab_size)
    assert got == expected, (arch, got, expected)
    jcfg = jconfigs.get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_params(), cfg.n_active_params()) == (
        jcfg.n_params(), jcfg.n_active_params())


def test_arch_ids_are_the_reference_s_in_its_order():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.PAPER_ARCHS == jconfigs.PAPER_ARCHS
    assert tconfigs.all_archs() == jconfigs.all_archs()


def test_input_shapes_equal_the_reference_s():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_effective_window_and_cache_len_match_jax(arch):
    """Over every input shape: the sliding-window policy and the cache
    length equal the reference's (long_500k switches attention archs to
    their window; SSM archs have none)."""
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    for name, shape in INPUT_SHAPES.items():
        jshape = J_INPUT_SHAPES[name]
        assert tasks.effective_window(tcfg, shape) == \
            jtasks.effective_window(jcfg, jshape), name
        assert tasks.effective_cache_len(tcfg, shape) == \
            jtasks.effective_cache_len(jcfg, jshape), name


# --------------------------------------------------------------- the data
@pytest.mark.parametrize("seed", [0, 3])
def test_token_stream_is_bitwise_the_reference_s(seed):
    got = TokenStream(512, 3, 17, seed=seed).batches()
    want = JTokenStream(512, 3, 17, seed=seed).batches()
    for _ in range(3):
        g, w = next(got), next(want)
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])

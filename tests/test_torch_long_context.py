"""The ``long_500k`` path on the CPU: windowed prefill and decode of the
port against the JAX package, at reduced sizes with the window cut to 16.

``long_500k`` (524288 positions, batch 1) switches every attention arch to
its sliding window (``tasks.effective_window``) and keeps a decode cache of
the window's length (``effective_cache_len``).  The reference's decode
joins that W-entry cache with the new entry and masks nothing, so one
decoded token attends W + 1 keys, where the forward's mask keeps W: a
prefill at W + 1, its caches cut to their last W entries, then decodes,
equals the forward at W + 1 at every decoded position, in both packages,
and at W it does not.  ``chip_smoke.py``'s phase 44 runs the same
procedure at full width on the card.

A long prefill without gradients runs its row-wise steps in pieces of the
sequence (``layers.seq_pieces``: the SwiGLU, Mamba-2's causal conv and its
skip, gated norm and ``out_proj``); whole, zamba2-2.7b's f32 SwiGLU
intermediates took a 12-layer prefill over 524160 tokens to 120 GB.  The
pieces are held against the JAX package here with the piece cut to 32
tokens, and their peak is measured on meta tensors at full width.

Parameters are made by the JAX package and carried across; tokens and
caches are drawn with numpy from a seed and fed to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import InputShape as JInputShape
from repro.models import tasks as jtasks
from repro.models.backbone import Backbone as JBackbone
from repro_torch import configs as tconfigs
from repro_torch.config import InputShape
from repro_torch.kernels import ref
from repro_torch.launch.dryrun import MemoryTracker
from repro_torch.models import layers, ssm, tasks
from repro_torch.models import params as tparams
from repro_torch.models.backbone import Backbone, map_cache_spec

from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ALL_ARCHS = tconfigs.ARCH_IDS + tconfigs.PAPER_ARCHS
W = 16
B = 2
# dense (qk_norm), GQA, MLA, the hybrid and two frontend archs (a GQA
# group of 7 and one of 1)
WINDOW_ARCHS = ["smollm-360m", "qwen3-32b", "deepseek-v2-236b",
                "zamba2-2.7b", "internvl2-1b", "musicgen-large"]
# the scan takes whole chunks (32 reduced): the hybrid prefills two
PREFILL = {"zamba2-2.7b": 64}
N_DECODE = 8
# the prefill shape of chip_smoke.py's phase 44: long_500k's length less
# its 128 decodes, a whole number of 128-token chunks
PREFILL_512K = (524160, 1, "prefill")


def _cfgs(arch, window=W):
    """The reduced ``arch`` in both packages at ``window``."""
    return (dataclasses.replace(jconfigs.get_reduced(arch), window=window),
            dataclasses.replace(tconfigs.get_reduced(arch), window=window))


def _params(jcfg, tcfg, seed=3):
    jp = jtasks.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return jp, tasks.init_params(tcfg, dtype=None, device="cpu", arrays=tree)


def _tokens(cfg, n, seed=4):
    """(numpy tokens (B, n), prefix embeddings (B, n_tokens, e) f32 or
    None)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n), dtype=np.int32)
    fe = cfg.frontend
    pe = (rng.standard_normal((B, fe.n_tokens, fe.embed_dim))
          .astype(np.float32) if fe.kind != "none" else None)
    return toks, pe


def _batches(toks, pe):
    """The prefill batch as each package takes it (prefix embeddings in
    bf16 in both, as ``tasks.synthetic_batch`` makes them)."""
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    if pe is not None:
        jb["prefix_embed"] = jnp.asarray(pe).astype(jnp.bfloat16)
        tb["prefix_embed"] = torch.from_numpy(pe).to(torch.bfloat16)
    return jb, tb


def _leaves(tree):
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _seq_axes(tcfg):
    """Each cache leaf's sequence dim (``cache_seq``) or None, in
    ``jax.tree.leaves`` order."""
    spec = Backbone(tcfg).cache_specs(B, 1)
    return _leaves(map_cache_spec(
        lambda leaf, _: (leaf[1].index("cache_seq")
                         if "cache_seq" in leaf[1] else None), spec))


def _rebuild(tree, leaves):
    """``tree``'s structure (tuples and NamedTuples) over ``leaves``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, tuple):
            vals = [walk(v) for v in node]
            return type(node)(*vals) if hasattr(node, "_fields") \
                else tuple(vals)
        return next(it)
    return walk(tree)


def _cut_leaves(leaves, axes, window):
    """Each leaf with a sequence dim cut to its last ``window`` entries
    (long_500k's window-sized cache), the others as they are."""
    return [x if a is None else x[(slice(None),) * a
                                  + (slice(x.shape[a] - window, None),)]
            for x, a in zip(leaves, axes)]


def _cut_jax(jc, axes, window):
    leaves, treedef = jax.tree.flatten(jc)
    return jax.tree.unflatten(treedef, _cut_leaves(leaves, axes, window))


def _cut_torch(tc, axes, window):
    return _rebuild(tc, [x.contiguous() for x in
                         _cut_leaves(_leaves(tc), axes, window)])


def _close(got, want, rel, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


def _close_caches(tc, jc, what):
    tl, jl = _leaves(tc), jax.tree.leaves(jc)
    assert len(tl) == len(jl)
    for i, (t, j) in enumerate(zip(tl, jl)):
        _close(t.numpy(), j, 1e-4, f"{what} cache leaf {i}")


@pytest.mark.parametrize("arch", WINDOW_ARCHS)
def test_prefill_decode_matches_jax(arch):
    """long_500k's procedure at window 16: a windowed prefill, every
    attention cache cut to its last 16 entries, then 8 decodes (greedy on
    the reference's logits) at window 16: each step's logits and every
    cache leaf, after the cut and after each decode, to 1e-4 of max(1,
    max |x|) of the reference's, f32."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    n = PREFILL.get(arch, 40)
    jb, tb = _batches(*_tokens(tcfg, n))
    jl, jc = jax.jit(jtasks.make_prefill_step(jcfg, window=W))(jp, jb)
    tl, tc = tasks.make_prefill_step(tcfg, window=W)(tp, tb)
    _close(tl.numpy(), jl, 1e-4, "prefill logits")
    axes = _seq_axes(tcfg)
    jc, tc = _cut_jax(jc, axes, W), _cut_torch(tc, axes, W)
    _close_caches(tc, jc, "prefill (cut)")
    jdec = jax.jit(jtasks.make_decode_step(jcfg, window=W))
    tdec = tasks.make_decode_step(tcfg, window=W)
    pos = n + tcfg.frontend.n_tokens
    for i in range(N_DECODE):
        tok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        jl, jc = jdec(jp, jc, jnp.asarray(tok), jnp.int32(pos + i))
        tl, tc = tdec(tp, tc, torch.from_numpy(tok), pos + i)
        _close(tl.numpy(), jl, 1e-4, f"decode {i} logits")
        _close_caches(tc, jc, f"decode {i}")


@pytest.mark.parametrize("arch", WINDOW_ARCHS)
def test_decode_at_last_long_position_matches_jax(arch):
    """One decode at long_500k's last position, 524287 (RoPE's angles at
    their largest), over window-sized caches drawn from a seed (every
    leaf, the SSM states too), against the reference's: logits and every
    rolled cache leaf to 1e-4 of max(1, max |x|), f32.  The reference's
    step runs op by op (``jax.disable_jit``, its block scan too): compiled,
    XLA's CPU backend fuses
    ``apply_rope``'s cos and sin with the angles' product and its result
    at these positions is 4.4e-3 off the float64 rotation of the same f32
    angles, where op by op, and the port, are within 2.2e-7
    (``test_rope_at_long_positions_matches_float64``)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg, seed=5)
    rng = np.random.default_rng(6)
    tc = tasks.init_caches(tcfg, B, W, torch.float32, "cpu")
    drawn = [rng.standard_normal(tuple(x.shape)).astype(np.float32)
             for x in _leaves(tc)]
    tc = _rebuild(tc, [torch.from_numpy(a.copy()) for a in drawn])
    # the reference's cache tree (its prefill's), leaf for leaf the port's
    _, shapes = jax.eval_shape(jtasks.make_prefill_step(jcfg, window=W), jp,
                               _batches(*_tokens(tcfg, 4))[0])
    jc = jax.tree.unflatten(jax.tree.structure(shapes),
                            [jnp.asarray(a) for a in drawn])
    tok = rng.integers(0, tcfg.vocab_size, (B, 1), dtype=np.int32)
    pos = 524287
    with jax.disable_jit():
        jlog, jc = jtasks.make_decode_step(jcfg, window=W)(
            jp, jc, jnp.asarray(tok), jnp.int32(pos))
    tlog, tc = tasks.make_decode_step(tcfg, window=W)(
        tp, tc, torch.from_numpy(tok), pos)
    _close(tlog.numpy(), jlog, 1e-4, "decode logits")
    _close_caches(tc, jc, "decode")


@pytest.mark.parametrize("pos0", [0, 524160, 524284])
def test_rope_at_long_positions_matches_float64(pos0):
    """``apply_rope`` at positions to long_500k's last, 524287, against
    the float64 rotation of the same f32 angles (the reference computes
    its angles in f32 too), to 5e-7 of max |x|; the reference op by op
    agrees with the port to 5e-7."""
    from repro.models import layers as jlayers
    x = np.random.default_rng(12).standard_normal(
        (1, 4, 2, 64)).astype(np.float32)
    pos = np.arange(pos0, pos0 + 4, dtype=np.int32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10000.0).numpy()
    freqs = layers.rope_frequencies(64, 10000.0).numpy()
    ang = (pos.astype(np.float32)[:, None] * freqs).astype(np.float64)
    cos, sin = np.cos(ang)[:, None], np.sin(ang)[:, None]
    x1, x2 = x[..., :32].astype(np.float64), x[..., 32:].astype(np.float64)
    want = np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    scale = float(np.abs(x).max())
    assert np.abs(got - want).max() <= 5e-7 * scale
    jgot = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         10000.0))
    assert np.abs(got - jgot).max() <= 5e-7 * scale


def _decode_vs_forward(package, arch, window_prefill, n_dec):
    """(max |decode - forward| over every decoded position, max |forward
    logits|) in ``package`` ("jax" or "torch"): a prefill at
    ``window_prefill``, every attention cache cut to its last ``W``
    entries, ``n_dec`` teacher-forced decodes at window ``W``, against
    the forward over prefill + decoded tokens at ``window_prefill``."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg, seed=7)
    n = PREFILL.get(arch, 40)
    toks, _ = _tokens(tcfg, n + n_dec, seed=8)
    axes = _seq_axes(tcfg)
    if package == "jax":
        _, jc = jax.jit(jtasks.make_prefill_step(
            jcfg, window=window_prefill))(jp, {"tokens": jnp.asarray(
                toks[:, :n])})
        jc = _cut_jax(jc, axes, W)
        dec = jax.jit(jtasks.make_decode_step(jcfg, window=W))
        outs = []
        for i in range(n, n + n_dec):
            lg, jc = dec(jp, jc, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
            outs.append(np.asarray(lg))
        model = JBackbone(jcfg)
        hidden, _, _ = jax.jit(lambda p, t: model.forward_embeds(
            p, model.embed_inputs(p, t), causal=True,
            window=window_prefill))(jp, jnp.asarray(toks))
        full = np.asarray(model.logits(jp, hidden[:, n:]))
    else:
        _, tc = tasks.make_prefill_step(tcfg, window=window_prefill)(
            tp, {"tokens": torch.from_numpy(toks[:, :n])})
        tc = _cut_torch(tc, axes, W)
        dec = tasks.make_decode_step(tcfg, window=W)
        outs = []
        for i in range(n, n + n_dec):
            lg, tc = dec(tp, tc, torch.from_numpy(toks[:, i:i + 1]), i)
            outs.append(lg.numpy())
        model = Backbone(tcfg)
        with torch.no_grad():
            hidden = model.forward_embeds(
                tp, model.embed_inputs(tp, torch.from_numpy(toks)),
                causal=True, window=window_prefill)
            full = model.logits(tp, hidden[:, n:]).numpy()
    got = np.stack(outs, 1)
    return float(np.abs(got - full).max()), float(np.abs(full).max())


@pytest.mark.parametrize("package", ["jax", "torch"])
@pytest.mark.parametrize("arch,n_dec", [("smollm-360m", N_DECODE),
                                        ("zamba2-2.7b", 32)])
def test_window_plus_one_prefill_and_decode_equal_the_forward(
        package, arch, n_dec):
    """The property both packages share: a prefill at W + 1, its caches
    cut to W entries, and decodes (each attending W cached keys and
    itself) equal the forward at W + 1 at every decoded position, to 1e-4
    of max |logits|, f32.  The hybrid decodes a whole chunk of 32 (its
    forward's scan takes whole chunks)."""
    gap, scale = _decode_vs_forward(package, arch, W + 1, n_dec)
    assert gap <= 1e-4 * scale, (gap, scale)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_window_prefill_and_decode_miss_the_forward(package):
    """At W the decode attends one key more than the forward's mask
    keeps: over 8 decodes of the reduced smollm-360m the gap passes 0.1
    of max |logits| in both packages (why the card's exact check runs the
    prefill and the forward at W + 1)."""
    gap, scale = _decode_vs_forward(package, "smollm-360m", W, N_DECODE)
    assert gap > 0.1 * scale, (gap, scale)


# rows of a causal attention at S = 300 under a window of 33: the first
# block (the window not yet full), one across row W, one in the middle, a
# ragged one and the last
BAND_S, BAND_W = 300, 33
BAND_BLOCKS = [(0, 64), (BAND_W - 20, 64), (150, 64), (201, 37), (236, 64)]


@pytest.mark.parametrize("r0,n", BAND_BLOCKS)
def test_attention_over_a_band_of_keys_equals_the_windowed_attention(r0, n):
    """The yardstick of phase 44's attention check: query rows [r0, r0 +
    n) against only the keys their window reaches, [max(0, r0 - W + 1),
    r0 + n), through ``layers.attention_chunked`` with ``q_positions`` /
    ``k_positions``, equal the rows of ``ref.flash_attention_ref`` over
    the whole sequence at that window (GQA 4 / 2, f32), to 1e-6."""
    g = torch.Generator().manual_seed(9)
    q = torch.randn(1, BAND_S, 4, 16, generator=g)
    k, v = (torch.randn(1, BAND_S, 2, 16, generator=g) for _ in range(2))
    want = ref.flash_attention_ref(q, k, v, causal=True, window=BAND_W)
    k0 = max(0, r0 - BAND_W + 1)
    got = layers.attention_chunked(
        q[:, r0:r0 + n], k[:, k0:r0 + n], v[:, k0:r0 + n], causal=True,
        window=BAND_W, q_positions=torch.arange(r0, r0 + n),
        k_positions=torch.arange(k0, r0 + n), chunk_q=16)
    torch.testing.assert_close(got, want[:, r0:r0 + n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_window_policy_at_a_long_prefill_matches_jax(arch):
    """``effective_window`` and ``effective_cache_len`` at phase 44's
    prefill shape (524160 tokens, over 65536: the attention archs take
    their window) and at ``long_500k`` equal the reference's."""
    tcfg, jcfg = tconfigs.get(arch), jconfigs.get(arch)
    for args in (PREFILL_512K, (524288, 1, "decode")):
        shape, jshape = InputShape("long", *args), JInputShape("long", *args)
        assert tasks.effective_window(tcfg, shape) == \
            jtasks.effective_window(jcfg, jshape)
        assert tasks.effective_cache_len(tcfg, shape) == \
            jtasks.effective_cache_len(jcfg, jshape)
    assert tasks.effective_window(tcfg, InputShape("long", *PREFILL_512K)) \
        == (0 if tcfg.family == "ssm" else tcfg.window or 8192)


# ----------------------------------------------------- the prefill's pieces
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b",
                                  "smollm-360m"])
def test_prefill_in_pieces_matches_jax(arch, monkeypatch):
    """A prefill over 96 tokens with the piece cut to 32: the SwiGLU, the
    Mamba-2 conv (each piece reading the 3 inputs before it) and the
    skip, gated norm and ``out_proj`` run three pieces, and the logits
    and every cache leaf equal the reference's whole prefill to 1e-4 of
    max(1, max |x|), f32; the same prefill whole (under ``enable_grad``,
    where nothing runs in pieces) agrees with the pieces to 1e-6."""
    monkeypatch.setattr(layers, "SEQ_PIECE", 32)
    calls = []
    pieces = layers.seq_pieces
    monkeypatch.setattr(layers, "seq_pieces", lambda fn, S: calls.append(
        layers.in_pieces(S)) or pieces(fn, S))
    jcfg, tcfg = _cfgs(arch, window=0)
    jp, tp = _params(jcfg, tcfg, seed=10)
    jb, tb = _batches(*_tokens(tcfg, 96, seed=11))
    jl, jc = jax.jit(jtasks.make_prefill_step(jcfg))(jp, jb)
    tl, tc = tasks.make_prefill_step(tcfg)(tp, tb)
    assert calls and all(calls)
    _close(tl.numpy(), jl, 1e-4, "prefill logits")
    _close_caches(tc, jc, "prefill")
    model = Backbone(tcfg)
    with torch.enable_grad():
        hidden, whole, _ = model.forward_embeds(
            tp, model.embed_inputs(tp, tb["tokens"]), return_caches=True)
        assert not layers.in_pieces(96)
    torch.testing.assert_close(tl, model.logits(tp, hidden[:, -1]).detach(),
                               rtol=0, atol=1e-6)
    for a, b in zip(_leaves(tc), _leaves(whole)):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=1e-6)


def _meta_peak(fn, *args) -> int:
    """Peak live bytes of ``fn(*args)`` on meta tensors (the dry run's
    tracker), the arguments included."""
    tracker = MemoryTracker(sum(a.untyped_storage().nbytes() for a in args))
    with tracker:
        fn(*args)
    return tracker.peak


@pytest.mark.parametrize("block", ["swiglu", "ssm"])
def test_long_prefill_blocks_fit_in_pieces(block):
    """The fault the pieces repair, at zamba2-2.7b's full width over phase
    44's 524160 tokens in bf16 on meta tensors: whole (as under
    ``enable_grad``), the shared block's SwiGLU peaks at ≥ 80 GB of f32
    gate, up and product, and one Mamba-2 block at ≥ 60 GB; in pieces of
    ``SEQ_PIECE`` tokens the SwiGLU's is under a fifth of that and the
    block's under half (its projection, conv output and scan output stay
    whole)."""
    cfg = tconfigs.get("zamba2-2.7b")
    x = torch.empty((1, PREFILL_512K[0], cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    if block == "swiglu":
        p = tparams.init(layers.mlp_spec(cfg.d_model, cfg.d_ff), None,
                         torch.bfloat16, "meta")

        def run(x):
            return layers.mlp(p, x)
        floor, share = 80e9, 5
    else:
        p = tparams.init(ssm.spec(cfg), None, torch.bfloat16, "meta")

        def run(x):
            return ssm.apply_full(p, cfg, x, return_cache=True)
        floor, share = 60e9, 2
    with torch.no_grad():
        pieces = _meta_peak(run, x)
        with torch.enable_grad():
            whole = _meta_peak(run, x)
    assert whole >= floor and pieces < whole / share, (whole, pieces)

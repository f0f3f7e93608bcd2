"""Parity of the port's model layer (``repro_torch.models``) with the JAX
package on the reduced ``flux_dit``, on the CPU: the spec tree, the weight
carrier, the shared layers and ``FlowAdapter.velocity``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import params as jparams
from repro_torch.models import layers as tlayers
from repro_torch.models import params as tparams
from repro_torch.models.backbone import Backbone

from torch_parity import (COND_DIM, COND_LEN, LATENT_DIM, LATENT_TOKENS,
                          adapters, normal, params_pair, to_torch)


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_spec_tree_matches_jax_key_for_key():
    ja, ta = adapters()
    jl = {p: (leaf.shape, leaf.axes, leaf.init)
          for p, leaf in _spec_leaves(ja.spec())}
    tl = {p: (leaf.shape, leaf.axes, leaf.init)
          for p, leaf in _spec_leaves(ta.spec())}
    assert sorted(jl) == sorted(tl)
    assert jl == tl
    assert tparams.n_params(ta.spec()) == jparams.n_params(ja.spec())


def test_full_flux_dit_spec_matches_jax():
    from repro import configs as jconfigs
    from repro.config import FlowRLConfig as JF
    from repro.models.flow import FlowAdapter as JA
    from repro_torch import configs as tconfigs
    from repro_torch.config import FlowRLConfig as TF
    from repro_torch.models.flow import FlowAdapter as TA
    jspec = JA(jconfigs.get("flux_dit"), JF(latent_tokens=4096,
                                            latent_dim=64), 4096).spec()
    tspec = TA(tconfigs.get("flux_dit"), TF(latent_tokens=4096,
                                            latent_dim=64), 4096).spec()
    assert ({p: l.shape for p, l in _spec_leaves(jspec)}
            == {p: l.shape for p, l in _spec_leaves(tspec)})
    # ≈8.1 B parameters at full width
    assert 8.0e9 < tparams.n_params(tspec) < 8.3e9


def test_other_families_are_not_ported():
    from repro_torch.config import ArchConfig
    cfg = ArchConfig(name="x", family="dense", n_layers=1, d_model=8,
                     n_heads=1, n_kv_heads=1, d_ff=8, vocab_size=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Backbone(cfg)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_from_numpy_round_trips_jax_params_bitwise(dtype):
    ja, _ = adapters()
    p = jparams.init(ja.spec(), jax.random.PRNGKey(3), dtype)
    tree = jax.tree.map(np.asarray, p)
    tp = tparams.from_numpy(tree, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sd = tparams.state_dict(tp)
    keys = {".".join(k.key for k in path) for path, _ in flat}
    assert set(sd) == keys
    for path, a in flat:
        t = sd[".".join(k.key for k in path)]
        assert tuple(t.shape) == a.shape
        if dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          a.view(np.int16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)


def test_init_draws_every_leaf_on_the_given_device():
    _, ta = adapters()
    gen = torch.Generator().manual_seed(0)
    p = tparams.init(ta.spec(), gen, torch.bfloat16, "cpu")
    sd = tparams.state_dict(p)
    assert all(t.dtype == torch.bfloat16 for t in sd.values())
    assert float(sd["backbone.blocks.ada"].abs().max()) == 0.0
    assert float(sd["backbone.blocks.ln1"].min()) == 1.0
    w = sd["backbone.blocks.ffn.w_gate"].float()
    # normal init at 1/sqrt(fan_in): d_model = 256 -> std 1/16
    assert abs(float(w.std()) - 1 / 16) < 2e-3
    g2 = torch.Generator().manual_seed(0)
    p2 = tparams.init(ta.spec(), g2, torch.bfloat16, "cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(sd.values(), tparams.state_dict(p2).values()))


# ------------------------------------------------------------------ layers
def test_rmsnorm_parity():
    x, w = normal(1, (2, 9, 64), (64,))
    got = tlayers.rmsnorm(to_torch(w), to_torch(x), 1e-5)
    want = jlayers.rmsnorm(jnp.asarray(w), jnp.asarray(x), 1e-5)
    # f32 mean of squares in another order: f32 rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-5)


def test_apply_rope_parity():
    (x,) = normal(2, (2, 17, 4, 32))
    pos = np.arange(17, dtype=np.int32)
    got = tlayers.apply_rope(to_torch(x), torch.from_numpy(pos), 1e6)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    # cos/sin of f32 angles from two libms: a few f32 ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=1e-5)


def test_mlp_parity():
    x, wg, wu, wd = normal(3, (2, 9, 64), (64, 128), (64, 128), (128, 64))
    jp = {"w_gate": jnp.asarray(wg), "w_up": jnp.asarray(wu),
          "w_down": jnp.asarray(wd)}
    tp = {k: to_torch(v) for k, v in jp.items()}
    got = tlayers.mlp(tp, to_torch(x))
    want = jlayers.mlp(jp, jnp.asarray(x))
    # f32 matmuls summed in another order over d = 64 and f = 128
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_timestep_embedding_parity():
    t = np.array([1 - 1e-4, 0.5, 1e-4], np.float32)
    for dim in (256, 33):
        got = tlayers.timestep_embedding(torch.from_numpy(t), dim)
        want = jlayers.timestep_embedding(jnp.asarray(t), dim)
        # args reach 1000 rad: cos/sin there are good to ~1e-4 absolute in
        # f32 whichever libm evaluates them
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


# ---------------------------------------------------------------- velocity
def _velocity_inputs(seed=0, B=2):
    x, cond = normal(seed, (B, LATENT_TOKENS, LATENT_DIM),
                     (B, COND_LEN, COND_DIM))
    t = np.array([0.9, 0.35][:B], np.float32)
    return x, t, cond


def test_velocity_f32_matches_jax():
    ja, ta = adapters()
    jp, tp = params_pair(ja, jnp.float32)
    x, t, cond = _velocity_inputs()
    want = np.asarray(ja.velocity(jp, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(cond)))
    got = ta.velocity(tp, to_torch(x), to_torch(t), to_torch(cond))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, LATENT_TOKENS, LATENT_DIM)
    # f32 end to end: matmul reduction order, and the port's attention
    # (the kernel's plain version, f32 p) against attention_chunked's
    # softmax: 1e-4
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # the blocks are live: zeroing ada changes the result
    tp0 = dict(tp, backbone=dict(tp["backbone"], blocks=dict(
        tp["backbone"]["blocks"],
        ada=torch.zeros_like(tp["backbone"]["blocks"]["ada"]))))
    v0 = ta.velocity(tp0, to_torch(x), to_torch(t), to_torch(cond))
    assert float((v0 - got).abs().max()) > 1e-2 * float(got.abs().max())


def test_velocity_bf16_matches_jax_within_bf16_band():
    ja, ta = adapters()
    jp, tp = params_pair(ja, jnp.bfloat16)
    x, t, cond = _velocity_inputs(1)
    want = np.asarray(ja.velocity(jp, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(cond)))
    got = ta.velocity(tp, to_torch(x), to_torch(t), to_torch(cond)).numpy()
    # bf16 activations round at other places (SwiGLU g/u and the time MLP
    # round to bf16 before silu; attention p stays f32): compared in f32 at
    # 3 % of the velocity's scale, a few bf16 ulps through two blocks
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=3e-2 * scale, rtol=0)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999

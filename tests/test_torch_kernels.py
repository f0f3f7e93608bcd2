"""Parity of the port's kernel layer (``repro_torch.kernels``) with the JAX
package's Pallas kernels and oracles, on the CPU.

On CPU tensors ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; these tests hold that version against ``repro.kernels.ref`` and the
interpret-mode Pallas kernels on the same numpy inputs.  The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.grpo_loss import grpo_loss as jgrpo
from repro.kernels.grpo_loss import grpo_loss_diff as jgrpo_diff
from repro.kernels.sde_step import sde_step as jsde
from repro.models.layers import attention_chunked as jattention_chunked
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd as cuda_flash_bwd)
from repro_torch.kernels.grpo_loss import grpo_loss as cuda_grpo
from repro_torch.kernels.grpo_loss import grpo_loss_bwd as cuda_grpo_bwd
from repro_torch.kernels.sde_step import sde_step as cuda_sde

from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(a, dtype):
    """The same numpy array as a torch tensor and a jax array of ``dtype``
    (bf16 rounding is done once, in jax, and carried across bit for bit)."""
    j = jnp.asarray(a).astype(JAX_DT[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH_DT[dtype])
    return t, j


# --------------------------------------------------------------- sde_step
# the sweep of tests/test_kernels.py::test_sde_step plus one odd feat (91)
@pytest.mark.parametrize("B,Lt,ld", [(2, 8, 4), (4, 64, 16), (1, 16, 8),
                                     (3, 7, 13)])
@pytest.mark.parametrize("eta", [0.3, 0.7])
@pytest.mark.parametrize("t,t_next", [(0.9, 0.8), (0.5, 0.4), (0.2, 0.1)])
def test_sde_step_plain_matches_jax(B, Lt, ld, eta, t, t_next):
    v, x, eps = _normal(B * 1000 + Lt, *[(B, Lt, ld)] * 3)
    xn, lp = ops.sde_step(torch.from_numpy(v), torch.from_numpy(x),
                          torch.from_numpy(eps), t, t_next, eta=eta)
    assert xn.dtype == lp.dtype == torch.float32
    assert tuple(xn.shape) == (B, Lt, ld) and tuple(lp.shape) == (B,)
    xk, lk = jsde(jnp.asarray(v), jnp.asarray(x), jnp.asarray(eps), t,
                  t_next, eta=eta, interpret=True)
    xr, lr = jref.sde_step_ref(jnp.asarray(v), jnp.asarray(x), t, t_next,
                               jnp.asarray(eps), eta=eta)
    # f32 elementwise arithmetic in another order (and t's f32 rounding
    # taken before, not after, 1 - t): 1e-5; logp is a row sum of up to
    # ~1000 terms: rtol 1e-5 of its magnitude
    for xo, lo in ((xk, lk), (xr, lr)):
        np.testing.assert_allclose(xn.numpy(), np.asarray(xo), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(lp.numpy(), np.asarray(lo), rtol=1e-5)


def test_sde_step_bf16_inputs_compute_in_f32():
    v, x, eps = _normal(7, *[(2, 16, 8)] * 3)
    tv, jv = _both(v, "bfloat16")
    tx, jx = _both(x, "bfloat16")
    te, je = _both(eps, "bfloat16")
    xn, lp = ops.sde_step(tv, tx, te, 0.5, 0.25, eta=0.7)
    xr, lr = jref.sde_step_ref(jv, jx, 0.5, 0.25, je, eta=0.7)
    assert xn.dtype == torch.float32
    # the same bf16 values upcast to f32 on both sides: f32 band
    np.testing.assert_allclose(xn.numpy(), np.asarray(xr), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lr), rtol=1e-5)


# ---------------------------------------------------------- flash attention
# the sweep of tests/test_kernels.py::test_flash_attention, plus ragged
# lengths that are no multiple of any tile (12 + 64 = the reduced DiT's
# cond + latent tokens, and a cross-length case)
@pytest.mark.parametrize("B,Sq,Sk,H,K,D", [
    (2, 128, 128, 4, 2, 64),
    (1, 256, 256, 2, 1, 32),
    (2, 128, 128, 4, 4, 128),
    (1, 512, 512, 8, 2, 64),
    (2, 76, 76, 4, 2, 32),
    (1, 100, 37, 4, 1, 64),
])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_jax_oracle(B, Sq, Sk, H, K, D, causal,
                                                  window, dtype):
    qn, kn, vn = _normal(Sq * 7 + D, (B, Sq, H, D), (B, Sk, K, D),
                         (B, Sk, K, D))
    (tq, jq), (tk, jk), (tv, jv) = (_both(a, dtype) for a in (qn, kn, vn))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == TORCH_DT[dtype] and tuple(out.shape) == (B, Sq, H, D)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    # the tolerances of tests/test_kernels.py: f32 sums in another order
    # (2e-5); bf16 output rounding, one bf16 ulp at |o| ~ 1 (2e-2)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,causal,window,dtype", [
    ((1, 128, 128, 2, 1, 32), True, 0, "float32"),
    ((2, 128, 128, 4, 2, 64), False, 0, "bfloat16"),
])
def test_flash_attention_plain_matches_pallas_interpret(shape, causal,
                                                        window, dtype):
    B, Sq, Sk, H, K, D = shape
    qn, kn, vn = _normal(11, (B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D))
    (tq, jq), (tk, jk), (tv, jv) = (_both(a, dtype) for a in (qn, kn, vn))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = jflash(jq, jk, jv, causal=causal, window=window, block_q=64,
                  block_k=64, interpret=True)
    # online softmax over 64-key blocks against one softmax: f32 2e-5,
    # bf16 2e-2 (as tests/test_kernels.py holds the kernel to its oracle)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_flash_attention_plain_matches_model_path():
    """The plain version agrees with the port's ``attention_chunked`` (the
    reference model's jnp path) in f32, across query chunks."""
    from repro_torch.models.layers import attention_chunked
    qn, kn, vn = _normal(5, (2, 200, 4, 32), (2, 200, 2, 32), (2, 200, 2, 32))
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    a = ops.flash_attention(q, k, v, causal=False)
    b = attention_chunked(q, k, v, causal=False, chunk_q=64)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=1e-4)


# ------------------------------------------------------------------ dispatch
def test_ops_routes_cpu_tensors_to_the_plain_versions(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import grpo_loss as grpo_mod
    monkeypatch.setattr(ops, "_flash", refuse)
    monkeypatch.setattr(ops, "_sde", refuse)
    monkeypatch.setattr(ops, "_grpo", refuse)
    for mod, name in ((fa_mod, "flash_attention"),
                      (fa_mod, "flash_attention_bwd"),
                      (grpo_mod, "grpo_loss"), (grpo_mod, "grpo_loss_bwd")):
        monkeypatch.setattr(mod, name, refuse)
    q = torch.zeros(1, 8, 2, 32)
    counters = (cuda_flash, cuda_flash_bwd, cuda_sde, cuda_grpo,
                cuda_grpo_bwd)
    before = [f.launches for f in counters]
    assert ops.flash_attention(q, q, q, causal=False).shape == q.shape
    xn, lp = ops.sde_step(q, q, q, 0.5, 0.4, eta=0.7)
    assert xn.shape == q.shape and lp.shape == (1,)
    r = torch.zeros(4)
    assert ops.grpo_loss(r, r, r, clip=0.2)[0].shape == (4,)
    # the autograd Functions route the same way, forward and backward
    qg = q.clone().requires_grad_()
    ops.flash_attention(qg, q, q, causal=False).sum().backward()
    rg = r.clone().requires_grad_()
    ops.grpo_loss_trainable(rg, r, r, clip=0.2)[0].sum().backward()
    assert qg.grad.shape == q.shape and rg.grad.shape == (4,)
    assert [f.launches for f in counters] == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The wrappers launch their kernel or raise; they never compute a CPU
    tensor through the plain version themselves."""
    q = torch.zeros(1, 8, 2, 32)
    lse = torch.zeros(1, 2, 8)
    r = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_flash(q, q, q, causal=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_flash(q, q, q, causal=False, return_lse=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_flash_bwd(q, q, q, q, lse, q, causal=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_sde(q, q, q, 0.5, 0.4, eta=0.7)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_grpo(r, r, r, clip=0.2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_grpo_bwd(r, r, r, r, clip=0.2)


def test_ops_has_no_fallback_switch():
    """No environment switch or try/except routes a CUDA tensor to the plain
    version: ops picks by device alone."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(ops))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    assert "environ" not in inspect.getsource(ops)


# ----------------------------------------------------------------- grpo_loss
def _grpo_inputs(B, seed=0):
    lpn, lpo, adv = _normal(seed + B, (B,), (B,), (B,))
    return lpn * 0.05, lpo * 0.05, adv


# the sweep of tests/test_kernels.py::test_grpo_loss
@pytest.mark.parametrize("B", [7, 64, 1031])
@pytest.mark.parametrize("clip", [0.1, 0.3])
@pytest.mark.parametrize("guard", [False, True])
def test_grpo_loss_plain_matches_jax(B, clip, guard):
    lpn, lpo, adv = _grpo_inputs(B)
    rm = np.float32(np.exp(np.clip(lpn - lpo, -20, 20)).mean())
    t = [torch.from_numpy(a) for a in (lpn, lpo, adv)]
    loss, frac = ops.grpo_loss(*t, torch.tensor([rm]), clip=clip,
                               guard=guard)
    assert loss.dtype == frac.dtype == torch.float32
    j = [jnp.asarray(a) for a in (lpn, lpo, adv)]
    for want_loss, want_frac in (
            jgrpo(*j, jnp.asarray(rm), clip=clip, guard=guard,
                  interpret=True),
            jref.grpo_loss_ref(*j, clip=clip, guard=guard)):
        # f32 elementwise ops, exp in another library, and the Guard mean
        # summed in another order: atol 1e-5 (the reference's own tolerance
        # between its kernel and its oracle)
        np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(frac.numpy(), np.asarray(want_frac))


def test_grpo_loss_plain_guard_defaults_to_the_batch_mean():
    lpn, lpo, adv = _grpo_inputs(33)
    t = [torch.from_numpy(a) for a in (lpn, lpo, adv)]
    a = ref.grpo_loss_ref(*t, clip=0.2, guard=True)
    want = jref.grpo_loss_ref(*(jnp.asarray(x) for x in (lpn, lpo, adv)),
                              clip=0.2, guard=True)
    np.testing.assert_allclose(a[0].numpy(), np.asarray(want[0]), atol=1e-6)


@pytest.mark.parametrize("clip", [0.05, 0.2])
def test_grpo_loss_backward_matches_jax_grad(clip):
    """The closed-form VJP (the plain ``grpo_loss_bwd_ref``, and the
    autograd Function on CPU tensors) against ``jax.grad`` of the
    reference's ``grpo_loss_diff`` with its Pallas forward in interpret
    mode (tests/test_kernels.py:265).  The closed form differs from
    autodiff of ``grpo_loss_ref`` only where |logp_new - logp_old| > 20
    (the clip of the log-ratio, which autodiff zeroes) and at exact ties
    of the min; the inputs stay clear of both."""
    lpn, lpo, adv = _grpo_inputs(32, seed=1)
    lpn, lpo = lpn * 2, lpo * 2          # log-ratios up to ~0.3: all branches
    g = np.random.default_rng(2).standard_normal(32).astype(np.float32)
    j = [jnp.asarray(a) for a in (lpn, lpo, adv)]

    def jloss(a, b, c):
        return jnp.sum(jgrpo_diff(a, b, c, clip, True) * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*j)
    t = [torch.from_numpy(a) for a in (lpn, lpo, adv)]
    got = ref.grpo_loss_bwd_ref(*t, torch.from_numpy(g), clip=clip)
    leaves = [a.clone().requires_grad_() for a in t]
    loss, frac = ops.grpo_loss_trainable(*leaves, clip=clip)
    loss.backward(torch.from_numpy(g))
    assert not frac.requires_grad
    for a, b, w in zip(got, leaves, want):
        # elementwise f32 products: atol 1e-6 (the reference holds its
        # custom VJP to autodiff at 1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5)
        np.testing.assert_array_equal(b.grad.numpy(), a.numpy())


# --------------------------------------------------------- attention backward
ATTN_BWD_SHAPES = [  # B, Sq, Sk, H, K, D, causal, window
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 76, 76, 2, 1, 32, False, 0),
    (2, 76, 76, 4, 4, 32, True, 16),
    (1, 100, 37, 4, 1, 64, True, 64),
]


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal,window", ATTN_BWD_SHAPES)
def test_flash_attention_backward_matches_jax_grad(B, Sq, Sk, H, K, D,
                                                   causal, window):
    """``ref.flash_attention_bwd_ref`` (from the forward's LSE) and the
    autograd Function on CPU tensors against ``jax.grad`` through the
    reference's ``attention_chunked`` (what its model differentiates) and
    through ``ref.flash_attention_ref``, in f32."""
    qn, kn, vn, gn = _normal(B * 100 + Sq + D, (B, Sq, H, D), (B, Sk, K, D),
                             (B, Sk, K, D), (B, Sq, H, D))
    jg = jnp.asarray(gn)

    def jloss(fn, q, k, v):
        return jnp.sum(fn(q, k, v, causal=causal, window=window) * jg)

    wants = [jax.grad(lambda q, k, v: jloss(fn, q, k, v), argnums=(0, 1, 2))(
        jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
        for fn in (jref.flash_attention_ref,
                   lambda q, k, v, **kw: jattention_chunked(q, k, v,
                                                            chunk_q=32,
                                                            **kw))]
    q, k, v, g = (torch.from_numpy(a) for a in (qn, kn, vn, gn))
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                         window=window)
    np.testing.assert_array_equal(
        o.numpy(), ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window).numpy())
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, g, causal=causal,
                                      window=window)
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    np.testing.assert_array_equal(out.detach().numpy(), o.numpy())
    out.backward(g)
    for want in wants:
        for a, b, w in zip(got, leaves, want):
            # f32 sums over up to 100 keys (or queries) in another order,
            # and D = sum dO O instead of sum P dP: 1e-4 of the gradient's
            # size (|grad| ~ 1-10 here)
            np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=1e-4)
            np.testing.assert_allclose(b.grad.numpy(), np.asarray(w),
                                       atol=1e-4, rtol=1e-4)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"

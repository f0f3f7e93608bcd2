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
from repro.kernels.sde_step import sde_step as jsde
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention as cuda_flash
from repro_torch.kernels.sde_step import sde_step as cuda_sde

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

    monkeypatch.setattr(ops, "_flash", refuse)
    monkeypatch.setattr(ops, "_sde", refuse)
    q = torch.zeros(1, 8, 2, 32)
    before = (cuda_flash.launches, cuda_sde.launches)
    assert ops.flash_attention(q, q, q, causal=False).shape == q.shape
    xn, lp = ops.sde_step(q, q, q, 0.5, 0.4, eta=0.7)
    assert xn.shape == q.shape and lp.shape == (1,)
    assert (cuda_flash.launches, cuda_sde.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """The wrappers launch their kernel or raise; they never compute a CPU
    tensor through the plain version themselves."""
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_flash(q, q, q, causal=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_sde(q, q, q, 0.5, 0.4, eta=0.7)


def test_ops_has_no_fallback_switch():
    """No environment switch or try/except routes a CUDA tensor to the plain
    version: ops picks by device alone."""
    import ast
    import inspect
    tree = ast.parse(inspect.getsource(ops))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    assert "environ" not in inspect.getsource(ops)


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"

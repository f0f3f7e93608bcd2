"""Parity of the port's Mamba-2 path with the JAX package, on the CPU: the
SSD scan's plain versions against the JAX oracle and the interpret-mode
Pallas kernel, the scan's closed-form backward (``ref.ssd_scan_bwd_ref``,
the CUDA backward's equations) against ``jax.vjp`` of the reference's
``ssd_chunked`` and torch autograd, ``SSDScanFn`` behind ``ops.ssd_scan``,
``ssm.apply_full``, the ``ssm`` backbone, the causal
``FlowAdapter.velocity``, ``rollout_keyed`` end to end and the serve CLI,
on reduced ``mamba2-370m``; and the full config's spec tree.

The scan's inputs cover the reference's sweep (``tests/test_kernels.py``)
and two slow-decay cases, in which the state carried across chunks makes
most of y: Mamba-2's own init (dt log-uniform in [1e-3, 1e-1], A in
[-16, -1], arXiv:2405.21060) and one with |dA| near 1e-3.  At the
repository's random init (a = -exp(N(0, 0.5^2)), dt ~ 0.7) the carried
state reaches only the first few tokens of a chunk, so those cases alone
could not tell a wrong inter-chunk decay.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import FlowRLConfig as JFlowRLConfig
from repro.core import schedulers as jsched
from repro.core.rollout import request_keys
from repro.core.rollout import rollout_keyed as jrollout_keyed
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.models import params as jparams
from repro.models import ssm as jssm
from repro.models.backbone import Backbone as JBackbone
from repro.models.flow import FlowAdapter as JFlowAdapter
from repro_torch import configs as tconfigs
from repro_torch.api.experiment import Experiment
from repro_torch.config import FlowRLConfig as TFlowRLConfig
from repro_torch.core import schedulers as tsched
from repro_torch.core.rollout import rollout_keyed as trollout_keyed
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.ssd_scan import SSDScanFn
from repro_torch.kernels.ssd_scan import ssd_scan as cuda_ssd_scan
from repro_torch.kernels.ssd_scan import ssd_scan_bwd as cuda_ssd_scan_bwd
from repro_torch.kernels.ssd_scan import (tensor_core_bwd_route,
                                          tensor_core_route)
from repro_torch.launch import serve as tserve
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.models.backbone import Backbone as TBackbone
from repro_torch.models.flow import FlowAdapter as TFlowAdapter

from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ARCH = "mamba2-370m"
# reduced mamba2: chunk 32, so [31 cond; 1 time; 64 latent] = 96 = 3 chunks
LATENT_TOKENS, LATENT_DIM = 64, 16
COND_LEN, COND_DIM = 31, 32
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

SWEEP = [(2, 128, 2, 32, 64, 32), (1, 256, 4, 64, 128, 128),
         (3, 64, 1, 16, 32, 64)]
SCAN_CASES = ([(shape, "sweep") for shape in SWEEP]
              + [((2, 256, 4, 16, 32, 64), "mamba2"),
                 ((1, 256, 2, 16, 32, 32), "slow")])


def _scan_inputs(seed, B, L, H, P, N, kind):
    """f32 numpy (x, dt, a, bm, cm).  ``sweep`` draws as the reference's
    sweep; ``mamba2`` Mamba-2's init; ``slow`` |dA| in [5e-4, 1.5e-3]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    bm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((B, L, N)) * 0.5).astype(np.float32)
    if kind == "sweep":
        dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))) * 0.5
        a = -np.exp(rng.standard_normal(H) * 0.3)
    elif kind == "mamba2":
        dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (B, L, H)))
        a = -rng.uniform(1.0, 16.0, H)
    else:
        dt = 1e-3 * rng.uniform(0.5, 1.5, (B, L, H))
        a = -rng.uniform(0.5, 1.5, H)
    return x, dt.astype(np.float32), a.astype(np.float32), bm, cm


def _pair(arrays, dtype):
    """The same inputs for both packages: x, bm, cm in ``dtype`` (rounded
    once from f32 by each, to the same bits), dt and a in f32."""
    x, dt, a, bm, cm = arrays
    jx, jb, jc = (jnp.asarray(v).astype(JAX_DT[dtype]) for v in (x, bm, cm))
    tx, tb, tc = (torch.from_numpy(v).to(TORCH_DT[dtype])
                  for v in (x, bm, cm))
    return ((jx, jnp.asarray(dt), jnp.asarray(a), jb, jc),
            (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc))


def _close(got, want, dtype):
    """f32: within 1e-4 of max |want|; bf16: the reference's own sweep
    tolerance (tests/test_kernels.py: atol 8e-2, rtol 0.1)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, atol=8e-2, rtol=0.1)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


# --------------------------------------------------------------- the scan
@pytest.mark.parametrize("case", SCAN_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}"
                              for s, k in SCAN_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_versions_match_jax_oracle_and_pallas(case, dtype):
    (B, L, H, P, N, Q), kind = case
    jin, tin = _pair(_scan_inputs(1, B, L, H, P, N, kind), dtype)
    y_o, h_o = jref.ssd_scan_ref(*jin)
    y_k, h_k = jssd_scan(*jin, chunk=Q, interpret=True)
    y_s, h_s = ref.ssd_scan_ref(*tin)
    y_c, h_c = ref.ssd_chunked_ref(*tin, Q)
    assert y_s.dtype == y_c.dtype == TORCH_DT[dtype]
    assert h_s.dtype == h_c.dtype == torch.float32
    for y, h in ((y_s, h_s), (y_c, h_c)):
        for y_want, h_want in ((y_o, h_o), (y_k, h_k)):
            _close(_np(y), _np(y_want), dtype)
            # the state is f32 on every route, whatever x's dtype
            _close(_np(h), _np(h_want), "float32")
    # ops routes a CPU tensor to the plain chunked version
    y_d, h_d = ops.ssd_scan(*tin, chunk=Q)
    assert torch.equal(y_d, y_c) and torch.equal(h_d, h_c)


@pytest.mark.parametrize("kind", ["mamba2", "slow"])
def test_slow_decay_cases_make_the_carried_state_dominate(kind):
    """The cases that check the inter-chunk decay: y from each chunk
    started at zero differs from y by more than half of max |y|."""
    B, L, H, P, N, Q = 1, 256, 2, 16, 32, 32
    _, tin = _pair(_scan_inputs(2, B, L, H, P, N, kind), "float32")
    y, _ = ref.ssd_chunked_ref(*tin, Q)
    x, dt, a, bm, cm = tin
    nc = L // Q
    local, _ = ref.ssd_chunked_ref(
        x.reshape(B * nc, Q, H, P), dt.reshape(B * nc, Q, H), a,
        bm.reshape(B * nc, Q, N), cm.reshape(B * nc, Q, N), Q)
    # more than half of max |y| comes from the carried state, so a carried
    # term off by 1e-3 of itself moves y by 5x the f32 band (1e-4 of max)
    assert float((local.reshape(y.shape) - y).abs().max()) > 0.5 * float(
        y.abs().max())


@pytest.mark.parametrize("B,L,H,P,N,Q", SWEEP)
def test_ssd_chunked_ref_matches_jax_ssd_chunked_with_init_state(B, L, H, P,
                                                                 N, Q):
    arrays = _scan_inputs(3, B, L, H, P, N, "mamba2")
    jin, tin = _pair(arrays, "float32")
    h0 = np.random.default_rng(4).standard_normal(
        (B, H, P, N)).astype(np.float32)
    for init in (None, h0):
        y_j, h_j = jssm.ssd_chunked(*jin, Q, None if init is None
                                    else jnp.asarray(init))
        y_t, h_t = ref.ssd_chunked_ref(*tin, Q, None if init is None
                                       else torch.from_numpy(init))
        _close(_np(y_t), _np(y_j), "float32")
        _close(_np(h_t), _np(h_j), "float32")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssd_scan_ref_chains_through_init_state(seed):
    """The scan over [a; b] equals the scan over a, then over b from a's
    final state (the reference's property test, tests/test_property.py),
    for the sequential and the chunked plain versions."""
    B, L, H, P, N = 2, 64, 3, 8, 16
    _, (x, dt, a, bm, cm) = _pair(_scan_inputs(seed, B, L, H, P, N,
                                               "mamba2"), "float32")
    h = L // 2
    for scan in (ref.ssd_scan_ref,
                 lambda *t, init_state=None: ref.ssd_chunked_ref(
                     *t, 16, init_state)):
        y_full, h_full = scan(x, dt, a, bm, cm)
        y1, h1 = scan(x[:, :h], dt[:, :h], a, bm[:, :h], cm[:, :h])
        y2, h2 = scan(x[:, h:], dt[:, h:], a, bm[:, h:], cm[:, h:],
                      init_state=h1)
        _close(h2.numpy(), h_full.numpy(), "float32")
        _close(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), "float32")


def test_sequence_must_be_a_multiple_of_the_chunk():
    """L = 96 against a chunk of 64: the reference asserts, the port
    raises; neither pads."""
    jin, tin = _pair(_scan_inputs(5, 1, 96, 2, 8, 16, "sweep"), "float32")
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*jin, 64)
    with pytest.raises(AssertionError):
        jssd_scan(*jin, chunk=64, interpret=True)
    with pytest.raises(ValueError, match="no multiple of the chunk"):
        ops.ssd_scan(*tin, chunk=64)
    # L < chunk runs as one chunk of L, in both packages
    y, _ = ops.ssd_scan(*tin, chunk=128)
    assert tuple(y.shape) == (1, 96, 2, 8)


# the two archs whose scans run on the tensor cores: Mamba-2 at state 128
# (d_in 2048, row stride 2304) and zamba2's SSM blocks at state 64 (d_in
# 5120, 80 heads of 64, row stride 5248)
TC_ARCHS = {"mamba2-370m": 2048 + 2 * 128, "zamba2-2.7b": 5120 + 2 * 64}


def _conv_slices(B, L, dtype, arch=ARCH):
    """x, bm, cm as ``ssm.apply_full`` hands them to the scan: column
    slices of one (B, L, d_in + 2N) conv output of full ``arch``."""
    m = tssm.dims(tconfigs.get(arch))
    conv = torch.zeros(B, L, m["d_in"] + 2 * m["N"], dtype=dtype)
    xh = conv[..., :m["d_in"]].reshape(B, L, m["H"], m["P"])
    bm = conv[..., m["d_in"]:m["d_in"] + m["N"]]
    cm = conv[..., m["d_in"] + m["N"]:]
    return xh, bm, cm, m["Q"]


def _misaligned_slices(arch, extra):
    """``arch``'s conv slices in a buffer ``extra`` columns wider, x
    starting one element in (``extra`` 8: an unaligned base) or at 0
    (``extra`` 1: an odd row stride)."""
    m = tssm.dims(tconfigs.get(arch))
    d_in, N = m["d_in"], m["N"]
    conv = torch.zeros(2, 256, d_in + 2 * N + extra, dtype=torch.bfloat16)
    o = 1 if extra == 8 else 0
    return (conv[..., o:o + d_in].reshape(2, 256, m["H"], m["P"]),
            conv[..., o + d_in:o + d_in + N],
            conv[..., o + d_in + N:o + d_in + 2 * N])


@pytest.mark.parametrize("arch", list(TC_ARCHS))
def test_tensor_core_route_takes_the_serving_path_and_nothing_else(arch):
    """The rule that picks the bf16 tensor-core kernel: the serving path's
    strided bf16 slices at Mamba-2's shape (state 128) and at zamba2's
    (state 64) go to it; f32, each odd shape of chip_smoke's phase 10
    (state 32 or 16, head dim 32, chunk 64), another chunk, an unaligned
    base or row stride go to the FMA passes.  The rule reads dtype, shape,
    strides and addresses only, so it is the same on the CPU."""
    xh, bm, cm, Q = _conv_slices(2, 256, torch.bfloat16, arch)
    assert xh.stride(1) == bm.stride(1) == TC_ARCHS[arch]
    assert tensor_core_route(xh, bm, cm, Q)
    assert tensor_core_route(xh[:1], bm[:1], cm[:1], Q)   # batch 1
    assert not tensor_core_route(*_conv_slices(2, 256, torch.float32, arch))
    assert not tensor_core_route(xh, bm, cm, 64)
    # phase 10's odd shapes, bf16: (B, L, H, P, N, chunk)
    for (B, L, H, P, N, chunk) in [(2, 128, 2, 32, 64, 32),
                                   (3, 64, 1, 16, 32, 64),
                                   (1, 21, 3, 8, 16, 32),
                                   (2, 96, 16, 32, 32, 32)]:
        x = torch.zeros(B, L, H, P, dtype=torch.bfloat16)
        b = torch.zeros(B, L, N, dtype=torch.bfloat16)
        assert not tensor_core_route(x, b, b, chunk), (B, L, H, P, N)
    # an unaligned base (one element in) and an odd row stride
    assert not tensor_core_route(*_misaligned_slices(arch, 8), 128)
    assert not tensor_core_route(*_misaligned_slices(arch, 1), 128)


def _cpu_inputs(route):
    """(x, dt, a, bm, cm, chunk) on the CPU that would take ``route`` on
    the card: a small f32 sweep case, or the serving path's bf16 slices
    at state 128 (``wgmma``, mamba2-370m) or 64 (``wgmma64``, zamba2)."""
    if route == "fma":
        _, tin = _pair(_scan_inputs(6, 1, 32, 2, 8, 16, "sweep"), "float32")
        return (*tin, 32)
    arch = "zamba2-2.7b" if route == "wgmma64" else ARCH
    xh, bm, cm, Q = _conv_slices(1, 128, torch.bfloat16, arch)
    H = xh.shape[2]
    return xh, torch.full((1, 128, H), 0.01), -torch.ones(H), bm, cm, Q


@pytest.mark.parametrize("route", ["fma", "wgmma", "wgmma64"])
def test_cuda_wrapper_refuses_cpu_tensors(route):
    """A CPU tensor never reaches the CUDA wrappers' kernels, forward or
    backward, whichever kernel its dtype and shape would pick: each raises
    (``ops`` and ``SSDScanFn`` route CPU tensors to the plain versions
    before them, and no launch is counted)."""
    x, dt, a, bm, cm, Q = _cpu_inputs(route)
    dy = torch.zeros(x.shape, dtype=x.dtype)
    tc = route.startswith("wgmma")
    assert tensor_core_route(x, bm, cm, Q) == tc
    assert tensor_core_bwd_route(x, bm, cm, dy, Q) == tc
    before = (cuda_ssd_scan.launches, dict(cuda_ssd_scan.variant_launches),
              cuda_ssd_scan_bwd.launches,
              dict(cuda_ssd_scan_bwd.variant_launches))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_ssd_scan(x, dt, a, bm, cm, chunk=Q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_ssd_scan_bwd(x, dt, a, bm, cm, dy, None, chunk=Q)
    y, h = ops.ssd_scan(x, dt, a, bm, cm, chunk=Q)
    assert y.dtype == x.dtype and h.dtype == torch.float32
    assert (cuda_ssd_scan.launches, dict(cuda_ssd_scan.variant_launches),
            cuda_ssd_scan_bwd.launches,
            dict(cuda_ssd_scan_bwd.variant_launches)) == before


@pytest.mark.parametrize("leaf", ["x", "dt", "a", "bm", "cm"])
def test_ssd_scan_gradient_reaches_each_input(leaf, monkeypatch):
    """With grad enabled and any input requiring grad, ``ops.ssd_scan``
    runs ``SSDScanFn``: on the CPU its backward is the plain closed form,
    and each leaf's gradient equals ``jax.vjp`` of the reference's
    ``ssd_chunked`` (f32, both outputs' cotangents drawn: 1e-4 of max |jax|,
    sums in another order).  Off the CPU the same call reaches the CUDA
    wrappers, never the plain versions: on ``meta`` tensors (the dry run's
    route) forward and backward return the kernels' shapes and dtypes
    without building, launching or counting anything."""
    names = ("x", "dt", "a", "bm", "cm")
    (B, L, H, P, N, Q), kind = SCAN_CASES[3]
    arrays = _scan_inputs(4, B, L, H, P, N, kind)
    jin, tin = _pair(arrays, "float32")
    rng = np.random.default_rng(5)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dh = rng.standard_normal((B, H, P, N)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, Q), *jin)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))[names.index(leaf)]
    cpu = dict(zip(names, tin))
    cpu[leaf] = cpu[leaf].clone().requires_grad_()
    y, h = ops.ssd_scan(*(cpu[n] for n in names), chunk=Q)
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
    torch.autograd.backward((y, h), (torch.from_numpy(dy),
                                     torch.from_numpy(dh)))
    got = cpu[leaf].grad.numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    meta = {n: t.to("meta") for n, t in zip(names, tin)}
    meta[leaf] = meta[leaf].requires_grad_()
    before = (cuda_ssd_scan.launches, dict(cuda_ssd_scan.variant_launches),
              cuda_ssd_scan_bwd.launches)

    def boom(*a, **k):
        raise AssertionError("a meta tensor reached a plain version or a "
                             "kernel build")
    for name in ("ssd_chunked_ref", "ssd_scan_bwd_ref"):
        monkeypatch.setattr(ref, name, boom)
    monkeypatch.setattr(_build, "load", boom)
    ym, hm = ops.ssd_scan(*(meta[n] for n in names), chunk=Q)
    torch.autograd.backward((ym, hm), (torch.from_numpy(dy).to("meta"),
                                       torch.from_numpy(dh).to("meta")))
    assert (ym.device.type, tuple(ym.shape), ym.dtype) == (
        "meta", tuple(y.shape), y.dtype)
    assert (tuple(hm.shape), hm.dtype) == (tuple(h.shape), h.dtype)
    g = meta[leaf].grad
    assert (g.device.type, tuple(g.shape), g.dtype) == (
        "meta", got.shape, cpu[leaf].dtype)
    assert (cuda_ssd_scan.launches, dict(cuda_ssd_scan.variant_launches),
            cuda_ssd_scan_bwd.launches) == before


# the closed-form backward against the reference's autodiff: f32 outputs
# to 1e-4 of max |jax| (sums in another order; measured <= 3.3e-5); in bf16
# dx, dbm and dcm are rounded once from f32 by both (a tie lands one bf16
# ulp, 2^-8, apart; measured <= 9.3e-4), ddt and da stay f32
BWD_BAND = {"float32": (1e-4,) * 5,
            "bfloat16": (1e-2, 1e-4, 1e-4, 1e-2, 1e-2)}


def _cotangents(seed, B, L, H, P, N, zero_dh):
    rng = np.random.default_rng(seed)
    dy = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dh = (np.zeros((B, H, P, N), np.float32) if zero_dh
          else rng.standard_normal((B, H, P, N)).astype(np.float32))
    return dy, dh


@pytest.mark.parametrize("case", SCAN_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}"
                              for s, k in SCAN_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", ["zero", "drawn"])
def test_ssd_scan_bwd_ref_matches_jax_vjp(case, dtype, dh):
    """``ref.ssd_scan_bwd_ref`` (the kernel's equations, written out)
    against ``jax.vjp`` of the reference's ``ssd_chunked`` on the same
    inputs and cotangents: dy in x's dtype, dhT f32 (``None`` for the
    zero one, as training passes it)."""
    (B, L, H, P, N, Q), kind = case
    jin, tin = _pair(_scan_inputs(2, B, L, H, P, N, kind), dtype)
    dy, dhT = _cotangents(3, B, L, H, P, N, dh == "zero")
    _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, Q), *jin)
    want = vjp((jnp.asarray(dy).astype(JAX_DT[dtype]), jnp.asarray(dhT)))
    got = ref.ssd_scan_bwd_ref(
        *tin, torch.from_numpy(dy).to(TORCH_DT[dtype]),
        None if dh == "zero" else torch.from_numpy(dhT), Q)
    assert [t.dtype for t in got] == [TORCH_DT[dtype], torch.float32,
                                      torch.float32, TORCH_DT[dtype],
                                      TORCH_DT[dtype]]
    for name, g, w, band in zip(("dx", "ddt", "da", "dbm", "dcm"), got,
                                want, BWD_BAND[dtype]):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=0,
                                   atol=band * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", SCAN_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}"
                              for s, k in SCAN_CASES])
@pytest.mark.parametrize("dh", ["zero", "drawn"])
def test_ssd_scan_bwd_ref_equals_torch_autograd(case, dh):
    """The closed form against torch autograd through
    ``ref.ssd_chunked_ref``, f32: 1e-4 of max |autograd| (one chain of f32
    sums against another; in f64 the two agree to 1e-14)."""
    (B, L, H, P, N, Q), kind = case
    _, tin = _pair(_scan_inputs(6, B, L, H, P, N, kind), "float32")
    dy, dhT = _cotangents(7, B, L, H, P, N, dh == "zero")
    leaves = [t.clone().requires_grad_() for t in tin]
    y, h = ref.ssd_chunked_ref(*leaves, Q)
    outs, cots = [y], [torch.from_numpy(dy)]
    if dh == "drawn":
        outs.append(h)
        cots.append(torch.from_numpy(dhT))
    want = torch.autograd.grad(outs, leaves, cots)
    got = ref.ssd_scan_bwd_ref(*tin, torch.from_numpy(dy),
                               None if dh == "zero" else
                               torch.from_numpy(dhT), Q)
    for name, g, w in zip(("dx", "ddt", "da", "dbm", "dcm"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * float(w.abs().max()),
                                   err_msg=name)


def test_ssd_scan_fn_saves_only_the_inputs():
    """``SSDScanFn`` keeps x, dt, a, bm and cm for its backward (it
    recomputes the chunk states), and an unused final state costs the
    backward nothing: autograd hands it ``None``."""
    (B, L, H, P, N, Q), kind = SCAN_CASES[0]
    _, tin = _pair(_scan_inputs(8, B, L, H, P, N, kind), "float32")
    leaves = [t.clone().requires_grad_() for t in tin]
    y, _ = SSDScanFn.apply(*leaves, Q)
    assert [t.data_ptr() for t in y.grad_fn.saved_tensors] == [
        t.data_ptr() for t in leaves]
    y.sum().backward()
    want = ref.ssd_scan_bwd_ref(*tin, torch.ones_like(tin[0]), None, Q)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


# the bands chip_smoke's phase 10 holds the bf16 kernel to, of max |oracle|
TC_Y_BAND, TC_H_BAND = 1e-2, 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# the tensor-core kernels' shapes over four chunks: head dim 64, chunk 128,
# state 128 (Mamba-2) and 64 (zamba2)
TC_STATES = [128, 64]


@pytest.mark.parametrize("N", TC_STATES)
@pytest.mark.parametrize("kind", ["sweep", "mamba2", "slow"])
def test_tensor_core_rounding_holds_the_bf16_bands(kind, N):
    """The tensor-core kernel's rounding, written out in plain PyTorch
    (``ref.ssd_tensor_core_ref``: L' and h_prev rounded once to bf16, the
    state-update operand split into bf16 hi + lo), against the JAX oracle
    at the kernel's shapes (head dim 64, state 128 or 64, chunk 128) over
    four chunks: y within 1e-2 and the final state within 1e-4 of max
    |oracle|, the bands the card holds the kernel to."""
    B, L, H, P, Q = 1, 512, 2, 64, 128
    jin, tin = _pair(_scan_inputs(7, B, L, H, P, N, kind), "bfloat16")
    y_o, h_o = jref.ssd_scan_ref(*jin)
    y_e, h_e = ref.ssd_tensor_core_ref(*tin, Q)
    assert y_e.dtype == torch.bfloat16 and h_e.dtype == torch.float32
    assert _rel(_np(y_e), _np(y_o)) <= TC_Y_BAND
    assert _rel(_np(h_e), _np(h_o)) <= TC_H_BAND


@pytest.mark.parametrize("N", TC_STATES)
def test_tensor_core_rounding_needs_the_state_split(N):
    """Why the state update takes two products: with its operand rounded
    once to bf16 (the hi part alone) the final state leaves its 1e-4 band,
    on the slow-decay draw where the state carries most of y, at either
    state width."""
    B, L, H, P, Q = 1, 512, 2, 64, 128
    jin, tin = _pair(_scan_inputs(7, B, L, H, P, N, "slow"), "bfloat16")
    _, h_o = jref.ssd_scan_ref(*jin)
    x, dt, a, bm, cm = (t.float() for t in tin)
    nc = L // Q
    xf = x.reshape(B, nc, Q, H, P).transpose(2, 3)
    dtf = dt.reshape(B, nc, Q, H).transpose(2, 3)
    bf = bm.reshape(B, nc, Q, N)
    cum = torch.cumsum(dtf * a[:, None], dim=-1)
    h = torch.zeros(B, H, P, N)
    for c in range(nc):
        total = cum[:, c, :, -1:]
        xw = (torch.exp(total - cum[:, c]) * dtf[:, c])[..., None] * xf[:, c]
        h = (torch.exp(total)[..., None] * h
             + xw.to(torch.bfloat16).float().transpose(-1, -2)
             @ bf[:, c][:, None])
    assert _rel(h.numpy(), _np(h_o)) > 5 * TC_H_BAND
    _, h_e = ref.ssd_tensor_core_ref(*tin, Q)
    assert _rel(_np(h_e), _np(h_o)) <= TC_H_BAND


# the tensor-core backward's rounding at the kernels' shapes over four
# chunks, by state width
TC_BWD_SHAPE = {N: (1, 512, 2, 64, N, 128) for N in TC_STATES}


def _tc_bwd_case(kind, dh, N):
    """bf16 inputs and cotangents for both packages, and ``jax.vjp`` of the
    reference's ``ssd_chunked`` at them, at state ``N``."""
    B, L, H, P, N, Q = TC_BWD_SHAPE[N]
    jin, tin = _pair(_scan_inputs(7, B, L, H, P, N, kind), "bfloat16")
    dy, dhT = _cotangents(3, B, L, H, P, N, dh == "zero")
    _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, Q), *jin)
    want = vjp((jnp.asarray(dy).astype(jnp.bfloat16), jnp.asarray(dhT)))
    tcot = (torch.from_numpy(dy).to(torch.bfloat16),
            None if dh == "zero" else torch.from_numpy(dhT))
    return tin, tcot, [_np(w) for w in want]


@pytest.mark.parametrize("N", TC_STATES)
@pytest.mark.parametrize("kind", ["sweep", "mamba2", "slow"])
@pytest.mark.parametrize("dh", ["zero", "drawn"])
def test_tensor_core_bwd_rounding_holds_the_card_bands(kind, dh, N):
    """The tensor-core backward's rounding, written out in plain PyTorch
    (``ref.ssd_tensor_core_bwd_ref``: h_prev, dh and exp(cum) dy split into
    bf16 hi + lo where they reach ddt or da, S M, dS and the carried
    operands rounded once), against ``jax.vjp`` of the reference at the
    kernels' shapes (head dim 64, state 128 or 64, chunk 128) over four
    chunks:
    every gradient within the band phase 14 holds the card's kernel to, dx,
    dbm, dcm 1e-2 and ddt, da 1e-4 of max |jax| (rehearsed: at most 6.0e-3
    and 2.7e-5)."""
    tin, tcot, want = _tc_bwd_case(kind, dh, N)
    got = ref.ssd_tensor_core_bwd_ref(*tin, *tcot, TC_BWD_SHAPE[N][-1])
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    for name, g, w, band in zip(("dx", "ddt", "da", "dbm", "dcm"), got,
                                want, BWD_BAND["bfloat16"]):
        assert _rel(_np(g), w) <= band, name


@pytest.mark.parametrize("N", TC_STATES)
@pytest.mark.parametrize("dropped", list(ref.TC_BWD_SPLITS))
def test_tensor_core_bwd_rounding_needs_each_split(dropped, N):
    """Why the backward splits h_prev, dh and exp(cum) dy into bf16 hi + lo:
    with any one of them rounded once (the hi part alone), ddt or da leaves
    its 1e-4 band on the slow-decay draw, where the carried state and its
    gradient make most of both; with all three split both hold it."""
    tin, tcot, want = _tc_bwd_case("slow", "zero", N)
    Q = TC_BWD_SHAPE[N][-1]
    kept = tuple(s for s in ref.TC_BWD_SPLITS if s != dropped)
    got = ref.ssd_tensor_core_bwd_ref(*tin, *tcot, Q, splits=kept)
    assert max(_rel(_np(got[1]), want[1]), _rel(_np(got[2]), want[2])) > (
        5 * BWD_BAND["bfloat16"][1])
    got = ref.ssd_tensor_core_bwd_ref(*tin, *tcot, Q)
    assert max(_rel(_np(got[1]), want[1]), _rel(_np(got[2]), want[2])) <= (
        BWD_BAND["bfloat16"][1])


@pytest.mark.parametrize("arch", list(TC_ARCHS))
def test_tensor_core_bwd_route_takes_the_training_path_and_nothing_else(
        arch):
    """The rule that picks the tensor-core backward: the forward's route
    (the training path's strided bf16 slices at Mamba-2's shape or at
    zamba2's state 64, batch 4 or 1) with a contiguous bf16 dy that starts
    on 16 bytes, as ``SSDScanFn`` hands it.  f32, another chunk, the odd
    shapes, a strided, misaligned or f32 dy go to the FMA passes."""
    xh, bm, cm, Q = _conv_slices(2, 256, torch.bfloat16, arch)
    dy = torch.zeros(xh.shape, dtype=torch.bfloat16)
    assert tensor_core_bwd_route(xh, bm, cm, dy, Q)
    assert tensor_core_bwd_route(xh[:1], bm[:1], cm[:1], dy[:1], Q)
    xf, bf, cf, _ = _conv_slices(2, 256, torch.float32, arch)
    assert not tensor_core_bwd_route(xf, bf, cf, dy.float(), Q)
    assert not tensor_core_bwd_route(xh, bm, cm, dy, 64)
    for (B, L, H, P, N, chunk) in [(2, 128, 2, 32, 64, 32),
                                   (3, 64, 1, 16, 32, 64),
                                   (1, 21, 3, 8, 16, 32),
                                   (2, 96, 16, 32, 32, 32)]:
        x = torch.zeros(B, L, H, P, dtype=torch.bfloat16)
        b = torch.zeros(B, L, N, dtype=torch.bfloat16)
        assert not tensor_core_bwd_route(x, b, b, torch.zeros_like(x),
                                         chunk), (B, L, H, P, N)
    # dy: strided (heads swapped), one element off 16 bytes, f32
    assert not tensor_core_bwd_route(
        xh, bm, cm, dy.transpose(1, 2).contiguous().transpose(1, 2), Q)
    flat = torch.zeros(dy.numel() + 1, dtype=torch.bfloat16)
    assert not tensor_core_bwd_route(xh, bm, cm,
                                     flat[1:].view(dy.shape), Q)
    assert not tensor_core_bwd_route(xh, bm, cm, dy.float(), Q)
    # the forward's route decides the rest: an unaligned x refuses both
    assert not tensor_core_bwd_route(*_misaligned_slices(arch, 8), dy, 128)


# ------------------------------------------------------------- the model
def _reduced():
    return jconfigs.get_reduced(ARCH), tconfigs.get_reduced(ARCH)


def _adapters():
    kw = dict(sde_type="flow_sde", eta=0.7, num_steps=3,
              latent_tokens=LATENT_TOKENS, latent_dim=LATENT_DIM)
    jc, tc = _reduced()
    return (JFlowAdapter(jc, JFlowRLConfig(**kw), COND_DIM),
            TFlowAdapter(tc, TFlowRLConfig(**kw), COND_DIM))


def _draw_ssm(tree, rng):
    """Redraw the SSM leaves from Mamba-2's own init (conv taps uniform in
    +-1/sqrt(4), A in [-16, -1], dt log-uniform in [1e-3, 1e-1] through
    the bias) and zero the skip D.  At the repository's init (conv taps at
    0.02, D = 1) the scan moves a block's output by about 0.5 % of its
    scale, so a parity check there would hardly see it."""
    if not isinstance(tree, dict):
        return tree
    if "a_log" not in tree:
        return {k: _draw_ssm(v, rng) for k, v in tree.items()}
    out = dict(tree)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), tree["dt_bias"].shape))
    draws = {"conv_w": rng.uniform(-0.5, 0.5, tree["conv_w"].shape),
             "a_log": np.log(rng.uniform(1.0, 16.0, tree["a_log"].shape)),
             "dt_bias": dt + np.log(-np.expm1(-dt)),
             "d_skip": np.zeros(tree["d_skip"].shape)}
    for k, v in draws.items():
        out[k] = v.astype(np.float32).astype(tree[k].dtype)
    return out


def _params(spec, dtype, seed=0, draw=True):
    """JAX params (SSM leaves drawn unless ``draw`` is False) and the same
    tree on the port's CPU, bit for bit."""
    p = jparams.init(spec, jax.random.PRNGKey(seed), JAX_DT[dtype])
    tree = jax.tree.map(np.asarray, p)
    if draw:
        tree = _draw_ssm(tree, np.random.default_rng(seed + 100))
    return jax.tree.map(jnp.asarray, tree), tparams.from_numpy(tree, "cpu")


def _band(got, want, dtype):
    """f32: 1e-4 of max |want|; bf16: the band of
    test_velocity_bf16_matches_jax_within_bf16_band (3e-2 of max |want|,
    correlation > 0.999): bf16 activations through the blocks, with the
    scan's sums taken in another order."""
    got, want = _np(got), _np(want)
    scale = float(np.abs(want).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * scale)
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("draw", [False, True], ids=["init", "drawn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_full_matches_jax(dtype, draw):
    jc, tc = _reduced()
    jp, tp = _params(jssm.spec(jc), dtype, seed=1, draw=draw)
    (h,) = [np.random.default_rng(7).standard_normal(
        (2, 96, jc.d_model)).astype(np.float32)]
    jh = jnp.asarray(h).astype(JAX_DT[dtype])
    th = torch.from_numpy(h).to(TORCH_DT[dtype])
    j_out, j_cache = jssm.apply_full(jp, jc, jh, return_cache=True)
    t_out, t_cache = tssm.apply_full(tp, tc, th, return_cache=True)
    assert t_out.dtype == TORCH_DT[dtype] and t_out.shape == th.shape
    _band(t_out, j_out, dtype)
    _band(t_cache.conv, j_cache.conv, dtype)
    _band(t_cache.state, j_cache.state, dtype)
    # with the leaves drawn the block's output is the scan's alone
    real = ops.ssd_scan
    try:
        ops.ssd_scan = lambda x, *a, chunk: (torch.zeros_like(x), None)
        t0, _ = tssm.apply_full(tp, tc, th)
    finally:
        ops.ssd_scan = real
    moved = float((t0 - t_out).abs().max()) / float(t_out.abs().max())
    assert moved > (0.5 if draw else 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_backbone_forward_embeds_matches_jax(dtype):
    jc, tc = _reduced()
    jb, tb = JBackbone(jc), TBackbone(tc)
    jp, tp = _params(jb.spec(), dtype, seed=2)
    (x,) = [np.random.default_rng(8).standard_normal(
        (2, 96, jc.d_model)).astype(np.float32)]
    want, _, _ = jb.forward_embeds(jp, jnp.asarray(x).astype(JAX_DT[dtype]))
    got = tb.forward_embeds(tp, torch.from_numpy(x).to(TORCH_DT[dtype]))
    _band(got, want, dtype)


def _velocity_inputs(seed=0, B=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, LATENT_TOKENS, LATENT_DIM)).astype(
        np.float32)
    cond = rng.standard_normal((B, COND_LEN, COND_DIM)).astype(np.float32)
    return x, np.array([0.9, 0.35][:B], np.float32), cond


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_velocity_matches_jax(dtype):
    ja, ta = _adapters()
    jp, tp = _params(ja.spec(), dtype, seed=3)
    x, t, cond = _velocity_inputs()
    want = ja.velocity(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond))
    got = ta.velocity(tp, torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(cond))
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (2, LATENT_TOKENS, LATENT_DIM)
    _band(got, want, dtype)
    # causal: the condition and time token precede the latents, so the
    # first latent's velocity does not depend on later latents
    x2 = x.copy()
    x2[:, 1:] += 1.0
    got2 = ta.velocity(tp, torch.from_numpy(x2), torch.from_numpy(t),
                       torch.from_numpy(cond))
    scale = float(got.abs().max())
    assert float((got2[:, 0] - got[:, 0]).abs().max()) <= 1e-6 * scale
    assert float((got2[:, 1:] - got[:, 1:]).abs().max()) > 1e-2 * scale


def test_full_mamba2_spec_matches_jax():
    kw = dict(latent_tokens=4096, latent_dim=64)
    jspec = JFlowAdapter(jconfigs.get(ARCH), JFlowRLConfig(**kw),
                         4096).spec()
    tspec = TFlowAdapter(tconfigs.get(ARCH), TFlowRLConfig(**kw),
                         4096).spec()
    jl = {p: (l.shape, l.axes, l.init, l.scale)
          for p, l in tparams.leaves(jspec)}
    tl = {p: (l.shape, l.axes, l.init, l.scale)
          for p, l in tparams.leaves(tspec)}
    assert jl == tl
    assert tl[("backbone", "blocks", "ssm", "in_proj")][0] == (48, 1024,
                                                                4384)
    # ≈0.43 B parameters: 0.42 B of backbone and the adapter's projections
    assert 0.40e9 < tparams.n_params(tspec) < 0.45e9
    assert tparams.n_params(tspec) == jparams.n_params(jspec)


def test_init_and_from_numpy_carry_the_ssm_leaves():
    ja, ta = _adapters()
    jp, tp = _params(ja.spec(), "bfloat16", seed=4)
    sd = tparams.state_dict(tp)
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             jp))[0]
    assert set(sd) == {".".join(k.key for k in path) for path, _ in flat}
    for path, a in flat:
        np.testing.assert_array_equal(
            sd[".".join(k.key for k in path)].view(torch.int16).numpy(),
            a.view(np.int16))
    g = torch.Generator().manual_seed(0)
    fresh = tparams.state_dict(tparams.init(ta.spec(), g, torch.float32,
                                            "cpu"))
    pre = "backbone.blocks.ssm."
    assert tuple(fresh[pre + "a_log"].shape) == (2, 16)
    # the "small" init at its 0.5 scale, and the zeros / ones leaves
    assert abs(float(fresh[pre + "a_log"].std()) - 0.5) < 0.15
    assert abs(float(fresh[pre + "conv_w"].std()) - 0.02) < 2e-3
    assert float(fresh[pre + "conv_b"].abs().max()) == 0.0
    assert float(fresh[pre + "d_skip"].min()) == 1.0
    assert float(fresh[pre + "norm"].max()) == 1.0


# ------------------------------------------------------ the slice as a whole
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
    ja, ta = _adapters()
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
    # f32 through three velocity evaluations of two SSD blocks and three
    # SDE steps: 2e-4 on latents of |x| ~ 1, as for flux_dit
    np.testing.assert_allclose(got.x0.numpy(), np.asarray(want.x0),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.logps.numpy(), np.asarray(want.logps),
                               rtol=1e-5)


TINY_ENCODER = {"cond_dim": COND_DIM, "cond_len": COND_LEN, "vocab": 256,
                "hidden": 64}


def test_serve_cli_runs_mamba2_reduced_on_cpu(tmp_path):
    out = tserve.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--sde", "flow_sde",
        "--requests", "3", "--max-batch", "2",
        "--set", "flow.num_steps=2", "--set", "flow.latent_tokens=32",
        "--set", "flow.latent_dim=8",
        "--set", f"data.encoder={json.dumps(TINY_ENCODER)}",
        "--stats-json", str(tmp_path / "stats.json")])
    lat = out["latents"]
    assert tuple(lat.shape) == (3, 32, 8) and torch.isfinite(lat).all()
    assert out["engine"].adapter.cfg.family == "ssm"
    stats = json.loads((tmp_path / "stats.json").read_text())
    assert stats["requests"] == 3 and stats["device"] == "cpu"


def test_experiment_resolves_full_mamba2_and_defaults_to_cuda():
    full = Experiment.from_cli(["--arch", ARCH, "--device", "cpu"])
    assert full.arch.n_layers == 48 and full.arch.ssm.d_state == 128
    red = Experiment.from_cli(["--arch", ARCH, "--reduced", "--device",
                               "cpu"])
    assert red.arch.name == "mamba2-370m-reduced"
    ap = Experiment.cli_parser("x")
    assert ap.parse_args(["--arch", ARCH]).device == "cuda"

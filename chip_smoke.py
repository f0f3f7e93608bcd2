#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero, and without a CUDA device the
script exits 2 before printing any result.

1. Device: CUDA with capability (9, 0); prints ``nvidia-smi``'s name and
   power limit.
2. Build: compiles every ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc per
   source, all started together) and prints the build seconds.
3. Kernels against their plain PyTorch versions on the card, at the shapes
   the serving and training paths give them and at small, odd, causal,
   windowed, GQA and ragged shapes: ``sde_step``, the attention forward
   (with and without its LSE output, ``o`` bitwise equal), the attention
   backward (against its plain version and against torch.autograd through
   the plain forward), ``grpo_loss`` and its backward; then the kernel,
   plain, bound and (for attention) SDPA times at the path shapes, with
   CUDA events and replayed CUDA graphs.
4. ``FlowAdapter.velocity`` at full ``flux_dit`` width, depth 2, through the
   kernels and through the plain versions, at the bf16 band.
5. The main path: ``repro_torch.launch.serve.main`` serving 4 requests of
   full ``flux_dit`` (38 blocks, bf16, random weights from a seed) at
   FLUX.1-dev's 1024x1024 geometry (4096 latent tokens of width 64, a
   512-token condition of width 4096) under ``flow_sde``, 4 steps.  The
   kernels' launch counts must match the path: ``sde_step`` 4 per batch and
   ``flash_attention`` 38 x 4 per batch.
6. One denoising step of the engine that phase 5 built, traced with
   ``torch.profiler``: device time by kernel group and the device's idle
   share over the step.
7. adaLN-zero leaves every fresh block the identity, so phase 5's latents
   never depend on attention or the MLP.  The modulation is drawn from a
   seed, the same 4 requests are served again through the engine and the
   kernels, and held against ``rollout_keyed`` through the plain versions.
8. The train path: ``repro_torch.launch.train.main`` trains ``flux_dit``
   at full width with 4 blocks (bf16, random weights from a seed) at the
   same geometry, ``flow_grpo`` under ``flow_sde`` with T = 4, 2 prompts x
   group 2, rewards ``text_render``/``pickscore``/``latent_norm`` under
   ``gdpo``, for 2 steps.  Launch counts per step must match the path
   (``sde_step`` T, attention forward 2 x 4 x T, attention backward 4 x T,
   ``grpo_loss`` and its backward T each); metrics must be finite and the
   params must move.  Prints s per train step, peak memory, the clip
   fraction and max |logp_new - logp_old| at rollout params, and a
   ``torch.profiler`` breakdown of one more train step.
9. One update (rollout, rewards, loss gradient, clip, AdamW) at full width,
   depth 2, batch 2, modulation drawn, through the kernels and, on the same
   injected draws, through the plain versions: loss, grad norm, the
   attention weights' grads and the params after AdamW at stated bands.
10. ``main_path``, ``train_path`` and ``kernels`` JSON lines, the card's
   name and power limit, and the last line ``{"ok": true, "device":
   {...}}``.

``--only N,...`` runs just the device and build phases and phases N (3, 8
or 9) and prints no result lines: a development aid.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.api import loop as loop_lib  # noqa: E402
from repro_torch.config import (FlowRLConfig, OptimConfig,  # noqa: E402
                                RewardSpec, replace)
from repro_torch.core.trainers import FlowGRPOTrainer  # noqa: E402
from repro_torch.core.rollout import (  # noqa: E402
    request_draws, request_seeds, rollout_keyed)
from repro_torch.data import synthetic_prompts  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import grpo_loss as grpo_mod  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd)
from repro_torch.kernels.grpo_loss import grpo_loss, grpo_loss_bwd  # noqa: E402
from repro_torch.kernels.sde_step import sde_step  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import params as params_lib  # noqa: E402
from repro_torch.models.flow import FlowAdapter  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): device memory and bf16 tensor
# cores; f32 outside the tensor cores for the elementwise kernel
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# path shapes
B_SERVE, LAT_TOKENS, LAT_DIM = 4, 4096, 64
COND_LEN, COND_DIM = 512, 4096
SEQ, HEADS, HEAD_DIM = COND_LEN + LAT_TOKENS, 24, 128
NUM_STEPS, N_LAYERS = 4, 38
BF16_BAND = 3e-2        # max |kernel - plain| / max |plain| through bf16 blocks
# bf16 attention at S=4608: outputs are ~sqrt(e/S) ~ 0.024 in std, so the
# short cases' absolute 2e-2 would pass a wrong kernel; the limit scales
# with max |plain| (0.19 there: 3.8e-3, four bf16 ulps at the top)
PATH_ATTN_BAND = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, warmed up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Mean device milliseconds of one ``fn`` call: ``calls`` calls captured
    in a CUDA graph and replayed, so the host's launch cost (Python, ctypes,
    allocation) drops out of the kernel's time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / (replays * calls)
    del graph
    return ms


def _plain_flash(q, k, v, *, causal=True, window=0, return_lse=False):
    o, lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                         window=window)
    return (o, lse) if return_lse else o


def _plain_flash_bwd(q, k, v, o, lse, do, *, causal=True, window=0):
    return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                       window=window)


def _plain_grpo(lpn, lpo, adv, ratio_mean=None, *, clip=0.2, guard=False):
    return ref.grpo_loss_ref(lpn, lpo, adv, clip=clip, guard=guard,
                             ratio_mean=ratio_mean)


@contextlib.contextmanager
def plain_dispatch():
    """Route every kernel call to its plain version on CUDA tensors too —
    ``ops``' wrappers and the autograd Functions' forwards and backwards —
    for the comparison runs of this script (the port itself has no such
    switch)."""
    saved = (ops._flash, ops._sde, ops._grpo, fa_mod.flash_attention,
             fa_mod.flash_attention_bwd, grpo_mod.grpo_loss,
             grpo_mod.grpo_loss_bwd)
    ops._flash = ref.flash_attention_ref
    ops._sde = lambda v, x, eps, t, t_next, eta: ref.sde_step_ref(
        v, x, t, t_next, eps, eta=eta)
    ops._grpo = _plain_grpo
    fa_mod.flash_attention = _plain_flash
    fa_mod.flash_attention_bwd = _plain_flash_bwd
    grpo_mod.grpo_loss = _plain_grpo
    grpo_mod.grpo_loss_bwd = ref.grpo_loss_bwd_ref
    try:
        yield
    finally:
        (ops._flash, ops._sde, ops._grpo, fa_mod.flash_attention,
         fa_mod.flash_attention_bwd, grpo_mod.grpo_loss,
         grpo_mod.grpo_loss_bwd) = saved


COUNTED = (sde_step, flash_attention, flash_attention_bwd, grpo_loss,
           grpo_loss_bwd)


def reset_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 3
def check_sde(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = [((B_SERVE, LAT_TOKENS, LAT_DIM), torch.float32),
              ((2, 8, 4), torch.float32), ((3, 7, 13), torch.bfloat16),
              ((1, 100003), torch.float32), ((5, 2049), torch.bfloat16)]
    path_err = None
    for shape, dt in shapes:
        v, x, e = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for _ in range(3))
        for t, tn in [(0.9999, 0.75), (0.5, 0.4), (0.25, 1e-4)]:
            xn, lp = sde_step(v, x, e, t, tn, eta=0.7)
            xn2, lp2 = sde_step(v, x, e, t, tn, eta=0.7)
            xr, lr = ref.sde_step_ref(v, x, t, tn, e, eta=0.7)
            torch.cuda.synchronize()
            xerr = float((xn - xr).abs().max())
            lerr = float(((lp - lr).abs() / lr.abs()).max())
            log(f"  sde_step {shape} {dt} t={t}: x_next max|err| {xerr:.3e}"
                f", logp max rel err {lerr:.3e}")
            if not torch.allclose(xn, xr, atol=1e-5, rtol=1e-5):
                fail(f"sde_step x_next off at {shape} {dt} t={t}")
            if lerr > 1e-5:
                fail(f"sde_step logp off at {shape} {dt} t={t}")
            if not (torch.equal(lp, lp2) and torch.equal(xn, xn2)):
                fail(f"sde_step not deterministic at {shape} {dt}")
            if shape[0] == B_SERVE and dt == torch.float32:
                path_err = max(path_err or 0.0, xerr)
    # times at the path shape over 4 input sets (67 MB, more than the 50 MB
    # L2), as the rollout meets v fresh from the velocity each step
    shape = (B_SERVE, LAT_TOKENS, LAT_DIM)
    sets = [[torch.randn(shape, generator=g, device=dev) for _ in range(3)]
            for _ in range(4)]
    it = [0]

    def run(fn):
        def call():
            v, x, e = sets[it[0] % 4]
            it[0] += 1
            fn(v, x, e)
        return call

    call_ms = cuda_ms(run(lambda v, x, e: sde_step(v, x, e, 0.5, 0.25)),
                      200)
    ms = graph_ms(run(lambda v, x, e: sde_step(v, x, e, 0.5, 0.25)), 40)
    plain_ms = cuda_ms(run(lambda v, x, e: ref.sde_step_ref(
        v, x, 0.5, 0.25, e, eta=0.7)), 50)
    n = B_SERVE * LAT_TOKENS * LAT_DIM
    nbytes = 3 * n * 4 + n * 4 + B_SERVE * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 12 * n / F32_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    log(f"  sde_step path {shape} f32: kernel {ms:.4f} ms on the device "
        f"({call_ms:.4f} ms a call with the host's launch), plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({nbytes / 1e6:.1f} MB)")
    return {"name": "sde_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sde_step.cu",
            "replaces": "src/repro/kernels/sde_step.py:50",
            "max_abs_err": path_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def check_attention(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(1)
    cases = [  # B, Sq, Sk, H, K, D, causal, window, dtype
        (1, SEQ, SEQ, HEADS, HEADS, HEAD_DIM, False, 0, torch.bfloat16),
        (2, 128, 128, 4, 2, 64, True, 0, torch.float32),
        (2, 128, 128, 4, 2, 64, False, 0, torch.bfloat16),
        (1, 76, 76, 2, 1, 32, False, 0, torch.float32),
        (2, 76, 76, 4, 4, 128, True, 16, torch.bfloat16),
        (1, 200, 130, 8, 2, 64, False, 0, torch.bfloat16),
        (1, 512, 512, 8, 2, 64, True, 64, torch.float32),
        (1, 100, 37, 4, 1, 64, True, 64, torch.bfloat16),
        (1, 300, 300, 4, 2, 128, False, 0, torch.float32),
    ]
    path_err = None
    for (B, Sq, Sk, H, K, D, causal, window, dt) in cases:
        q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        o = flash_attention(q, k, v, causal=causal, window=window)
        r = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((o.float() - r.float()).abs().max())
        log(f"  flash_attention B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} "
            f"causal={causal} window={window} {dt}: max|err| {err:.3e}")
        if Sq == SEQ:
            limit = PATH_ATTN_BAND * float(r.float().abs().max())
            log(f"    path shape: limit {limit:.3e} "
                f"({PATH_ATTN_BAND} of max|plain|)")
            ok = err <= limit
            path_err = err
        else:
            tol = 2e-5 if dt == torch.float32 else 2e-2
            ok = torch.allclose(o.float(), r.float(), atol=tol, rtol=tol)
        if not ok:
            fail(f"flash_attention off at {(B, Sq, Sk, H, K, D)}")
        del q, k, v, o, r
    # bf16 rows that are no multiple of 16 bytes apart take the f32-FMA
    # kernel instead of the tensor-core one
    q, k, v = (torch.randn(2, 76, 4, 34, generator=g, device=dev).to(
        torch.bfloat16)[..., :32] for _ in range(3))
    o = flash_attention(q, k, v, causal=True)
    r = ref.flash_attention_ref(q, k, v, causal=True)
    err = float((o.float() - r.float()).abs().max())
    log(f"  flash_attention strided bf16 (head stride 34): max|err| "
        f"{err:.3e}")
    if not torch.allclose(o.float(), r.float(), atol=2e-2, rtol=2e-2):
        fail("flash_attention off on strided bf16 inputs")
    torch.cuda.empty_cache()
    # times at the serving shape: B=4, S=4608, 24 heads of 128, bf16
    shp = (B_SERVE, SEQ, HEADS, HEAD_DIM)
    q, k, v = (torch.randn(shp, generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))
    ms = graph_ms(lambda: flash_attention(q, k, v, causal=False), 3)
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                       causal=False), 2, 1)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt), 10)
    flops = 4 * B_SERVE * HEADS * SEQ * SEQ * HEAD_DIM
    nbytes = 4 * q.numel() * 2
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    log(f"  flash_attention path {shp} bf16: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, SDPA {library_ms:.3f} ms, bound {bound:.3f} ms "
        f"({flops / 1e12:.3f} TFLOP)")
    del q, k, v
    torch.cuda.empty_cache()
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:81",
            "max_abs_err": path_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


ATTN_BWD_CASES = [  # B, Sq, Sk, H, K, D, causal, window, dtype
    (2, 128, 128, 4, 2, 64, True, 0, torch.float32),
    (2, 128, 128, 4, 2, 64, False, 0, torch.bfloat16),
    (1, 76, 76, 2, 1, 32, False, 0, torch.float32),
    (2, 76, 76, 4, 4, 128, True, 16, torch.bfloat16),
    (1, 200, 130, 8, 2, 64, False, 0, torch.bfloat16),
    (1, 512, 512, 8, 2, 64, True, 64, torch.float32),
    (1, 100, 37, 4, 1, 64, True, 64, torch.bfloat16),
    (1, 300, 300, 4, 2, 128, False, 0, torch.float32),
    (1, 300, 300, 4, 2, 128, True, 0, torch.bfloat16),
    (1, SEQ, SEQ, HEADS, HEADS, HEAD_DIM, False, 0, torch.bfloat16),
]
# max |kernel - plain| / max |plain| of each of dq, dk, dv: f32 sums in
# another order; bf16 rounds P and dS for the second products and the
# outputs once (one bf16 ulp is 2^-8 of the top binade)
ATTN_BWD_BAND = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_BAND = 1e-5          # max |lse - plain| / max(1, max |plain lse|)


def _grad_errs(got, want) -> list:
    return [float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), 1e-30)
            for a, b in zip(got, want)]


def check_attention_bwd(dev) -> dict:
    """The forward's LSE output and the backward kernel against their plain
    versions, and against torch.autograd through the plain forward."""
    g = torch.Generator(device=dev).manual_seed(3)
    path_err = None
    for (B, Sq, Sk, H, K, D, causal, window, dt) in ATTN_BWD_CASES:
        q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, K, D, generator=g, device=dev).to(dt)
        do = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
        o0 = flash_attention(q, k, v, causal=causal, window=window)
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 return_lse=True)
        if not torch.equal(o0, o):
            fail(f"flash_attention: o with the LSE output differs from o "
                 f"without it at {(B, Sq, Sk, H, K, D)} {dt}")
        _, lse_ref = ref.flash_attention_fwd_ref(q, k, v, causal=causal,
                                                 window=window)
        lse_err = float((lse - lse_ref).abs().max()) / max(
            1.0, float(lse_ref.abs().max()))
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                  window=window)
        again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"flash_attention_bwd not deterministic at "
                 f"{(B, Sq, Sk, H, K, D)} {dt}")
        # the plain backward on the same (q, k, v, o, lse, do), one batch
        # row at a time (at the path shape a whole (B, S, H, S) f32 score
        # tensor is 8 GB)
        want = [torch.cat(t) for t in zip(*(
            ref.flash_attention_bwd_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                        o[i:i + 1], lse[i:i + 1],
                                        do[i:i + 1], causal=causal,
                                        window=window) for i in range(B)))]
        errs = _grad_errs(got, want)
        # torch.autograd through the plain forward, in f32, batch row 0
        leaves = [a[:1].float().requires_grad_() for a in (q, k, v)]
        ref.flash_attention_ref(*leaves, causal=causal,
                                window=window).backward(do[:1].float())
        auto = _grad_errs([a[:1] for a in got], [a.grad for a in leaves])
        torch.cuda.synchronize()
        band = ATTN_BWD_BAND[dt]
        log(f"  flash_attention_bwd B={B} Sq={Sq} Sk={Sk} H={H} K={K} D={D} "
            f"causal={causal} window={window} {dt}: dq/dk/dv vs plain "
            f"{errs[0]:.2e}/{errs[1]:.2e}/{errs[2]:.2e}, vs autograd "
            f"{auto[0]:.2e}/{auto[1]:.2e}/{auto[2]:.2e} of max|plain| "
            f"(band {band}); lse {lse_err:.2e}")
        if lse_err > LSE_BAND:
            fail(f"flash_attention lse off at {(B, Sq, Sk, H, K, D)} {dt}")
        if max(errs + auto) > band:
            fail(f"flash_attention_bwd off at {(B, Sq, Sk, H, K, D)} {dt}")
        if Sq == SEQ:
            path_err = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(got, want))
        del q, k, v, do, o, o0, lse, lse_ref, got, again, want, leaves
        torch.cuda.empty_cache()
    # times at the training path's shape: B=4, S=4608, 24 heads of 128
    shp = (4, SEQ, HEADS, HEAD_DIM)
    q, k, v, do = (torch.randn(shp, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    # the forward's LSE variant, the one the training loss runs
    lse_fwd_ms = graph_ms(lambda: flash_attention(
        q, k, v, causal=False, return_lse=True), 2)
    ms = graph_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                              causal=False), 2)
    plain_ms = cuda_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, causal=False), 1, 1)
    torch.cuda.empty_cache()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_()
                  for a in (q, k, v))
    out = sdpa(qt, kt, vt)
    dot = do.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), 5)
    flops = 10 * shp[0] * HEADS * SEQ * SEQ * HEAD_DIM
    nbytes = (4 + 3) * q.numel() * 2 + 4 * lse.numel()
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(t_ops, t_bytes)
    log(f"  flash_attention_bwd path {shp} bf16: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, SDPA backward {library_ms:.3f} ms, bound "
        f"{bound:.3f} ms ({flops / 1e12:.3f} TFLOP); the forward with its "
        f"LSE output {lse_fwd_ms:.3f} ms")
    del q, k, v, do, o, lse, qt, kt, vt, out, dot
    torch.cuda.empty_cache()
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "none (JAX autodiff of src/repro/models/"
                        "attention.py:71, attention_chunked)",
            "max_abs_err": path_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "forward_with_lse_ms": lse_fwd_ms}


GRPO_BATCHES = (7, 64, 1031, 4)
GRPO_BAND = 1e-6         # max |kernel - plain| / max(1, max |plain|)


def check_grpo(dev) -> list:
    """grpo_loss forward (loss, frac; guard on and off) and its backward
    kernel against the plain versions over the reference's sweep, then
    their times at the training path's batch (B = 4)."""
    g = torch.Generator(device=dev).manual_seed(4)
    err_f = err_b = 0.0
    for B in GRPO_BATCHES:
        lpn = torch.randn(B, generator=g, device=dev) * 0.05
        lpo = torch.randn(B, generator=g, device=dev) * 0.05
        adv = torch.randn(B, generator=g, device=dev)
        gl = torch.randn(B, generator=g, device=dev)
        rm = torch.exp(torch.clamp(lpn - lpo, -20, 20)).mean().reshape(1)
        for clip in (0.1, 0.3):
            for guard in (False, True):
                loss, frac = grpo_loss(lpn, lpo, adv, rm, clip=clip,
                                       guard=guard)
                lr, fr = ref.grpo_loss_ref(lpn, lpo, adv, clip=clip,
                                           guard=guard, ratio_mean=rm)
                e = float((loss - lr).abs().max()) / max(
                    1.0, float(lr.abs().max()))
                if e > GRPO_BAND or not torch.equal(frac, fr):
                    fail(f"grpo_loss off at B={B} clip={clip} "
                         f"guard={guard}: {e:.3e}")
                err_f = max(err_f, e)
            got = grpo_loss_bwd(lpn, lpo, adv, gl, clip=clip)
            want = ref.grpo_loss_bwd_ref(lpn, lpo, adv, gl, clip=clip)
            e = max(float((a - b).abs().max()) / max(1.0, float(
                b.abs().max())) for a, b in zip(got, want))
            if e > GRPO_BAND:
                fail(f"grpo_loss_bwd off at B={B} clip={clip}: {e:.3e}")
            err_b = max(err_b, e)
            # the autograd Function on CUDA tensors launches both kernels
            x = lpn.clone().requires_grad_()
            n0 = (grpo_loss.launches, grpo_loss_bwd.launches)
            loss, _ = ops.grpo_loss_trainable(x, lpo, adv, clip=clip)
            loss.backward(gl)
            if (grpo_loss.launches - n0[0], grpo_loss_bwd.launches - n0[1]) \
                    != (1, 1) or not torch.equal(x.grad, got[0]):
                fail("GRPOLossFn did not run the kernels forward and back")
    torch.cuda.synchronize()
    log(f"  grpo_loss over B {GRPO_BATCHES}, clip 0.1/0.3, guard off/on: "
        f"forward max rel err {err_f:.3e}, backward {err_b:.3e} "
        f"(band {GRPO_BAND}); frac equal")
    B = 4
    lpn, lpo, adv, gl = (torch.randn(B, generator=g, device=dev)
                         for _ in range(4))
    rows = []
    for name, kern, plain, n_in, n_out in (
            ("grpo_loss",
             lambda: grpo_loss(lpn, lpo, adv, clip=1e-4),
             lambda: ref.grpo_loss_ref(lpn, lpo, adv, clip=1e-4), 3, 2),
            ("grpo_loss_bwd",
             lambda: grpo_loss_bwd(lpn, lpo, adv, gl, clip=1e-4),
             lambda: ref.grpo_loss_bwd_ref(lpn, lpo, adv, gl, clip=1e-4),
             4, 3)):
        ms = graph_ms(kern, 40)
        call_ms = cuda_ms(kern, 200)
        plain_ms = cuda_ms(plain, 200)
        nbytes = (n_in + n_out) * B * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  {name} B={B}: kernel {ms:.4f} ms on the device ({call_ms:.4f}"
            f" ms a call with the host's launch), plain {plain_ms:.4f} ms, "
            f"bound {bound:.2e} ms ({nbytes} bytes)")
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/grpo_loss.cu",
                     "replaces": ("src/repro/kernels/grpo_loss.py:36"
                                  if name == "grpo_loss" else
                                  "src/repro/kernels/grpo_loss.py:80"),
                     "max_abs_err": err_f if name == "grpo_loss" else err_b,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes", "library_ms": None})
    return rows


def draw_modulation(p: dict, d_model: int, seed: int) -> None:
    """adaLN-zero starts every block as the identity; draw the modulation
    (one layer at a time, in place) so that attention and MLP really shape
    the output."""
    ada = p["backbone"]["blocks"]["ada"]
    gen = torch.Generator(device=ada.device).manual_seed(seed)
    for layer in ada:
        layer.copy_(torch.randn(layer.shape, generator=gen,
                                device=ada.device) * (0.5 / d_model ** 0.5))


# ------------------------------------------------------------------ phase 4
def check_velocity(dev) -> None:
    cfg = replace(configs.get("flux_dit"), n_layers=2)
    adapter = FlowAdapter(cfg, FlowRLConfig(latent_tokens=LAT_TOKENS,
                                            latent_dim=LAT_DIM), COND_DIM)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = params_lib.init(adapter.spec(), gen, torch.bfloat16, dev)
    draw_modulation(p, cfg.d_model, seed=1)
    x = torch.randn(1, LAT_TOKENS, LAT_DIM, generator=gen, device=dev)
    cond = torch.randn(1, COND_LEN, COND_DIM, generator=gen, device=dev)
    t = torch.tensor([0.7], device=dev)
    with torch.no_grad():
        n0 = flash_attention.launches
        vk = adapter.velocity(p, x, t, cond)
        if flash_attention.launches - n0 != cfg.n_layers:
            fail("velocity did not run the attention kernel once per block")
        with plain_dispatch():
            vp = adapter.velocity(p, x, t, cond)
    torch.cuda.synchronize()
    err = float((vk - vp).abs().max())
    scale = float(vp.abs().max())
    log(f"  velocity flux_dit depth 2 (1, {SEQ} tokens) bf16: max|kernel - "
        f"plain| {err:.3e} of max|v| {scale:.3e}")
    if not (torch.isfinite(vk).all() and err <= BF16_BAND * scale):
        fail("velocity through the kernels is off the bf16 band")


# ------------------------------------------------------------------ phase 5
def main_path() -> dict:
    argv = ["--arch", "flux_dit", "--sde", "flow_sde", "--device", "cuda",
            "--requests", str(B_SERVE), "--max-batch", str(B_SERVE),
            "--bucket", str(B_SERVE),
            "--set", f"flow.num_steps={NUM_STEPS}",
            "--set", f"flow.latent_tokens={LAT_TOKENS}",
            "--set", f"flow.latent_dim={LAT_DIM}",
            "--set", "param_dtype=bfloat16",
            "--set", "data.encoder=" + json.dumps(
                {"cond_dim": COND_DIM, "cond_len": COND_LEN})]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = serve.main(argv)
    launches = counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    stats, lat = out["stats"], out["latents"]
    batches = len(out["warmup"]) + sum(stats["dispatches"].values())
    serve_batches = sum(stats["dispatches"].values())
    log(f"  launches {launches} over {batches} batches (warmup + serve)")
    if tuple(lat.shape) != (B_SERVE, LAT_TOKENS, LAT_DIM):
        fail(f"latents have shape {tuple(lat.shape)}")
    if not torch.isfinite(lat).all():
        fail("served latents are not finite")
    if launches["sde_step"] != NUM_STEPS * batches:
        fail(f"sde_step launched {launches['sde_step']} times, expected "
             f"{NUM_STEPS * batches}")
    if launches["flash_attention"] != N_LAYERS * NUM_STEPS * batches:
        fail(f"flash_attention launched {launches['flash_attention']} "
             f"times, expected {N_LAYERS * NUM_STEPS * batches}")
    serve_s = out["serve_s"]
    res = {"engine": out["engine"], "latents": lat,
           "launches": launches, "batches": batches,
           "req_per_s": B_SERVE / serve_s,
           "s_per_step": serve_s / (serve_batches * NUM_STEPS),
           "serve_s": serve_s, "warmup_s": out["warmup_s"],
           "peak_bytes": peak}
    log(f"  main path: {res['req_per_s']:.4f} req/s, {res['s_per_step']:.4f}"
        f" s per denoising step (batch {B_SERVE}), max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    return res


# ------------------------------------------------------------------ phase 6
PROFILE_GROUPS = (
    ("flash_attention kernel", ("attn_fwd",)),
    ("flash_attention_bwd kernel", ("bwd_delta", "bwd_dkdv", "bwd_dq")),
    ("sde_step kernel", ("sde_step_chunks", "sde_logp_rows")),
    ("grpo_loss kernels", ("grpo_fwd", "grpo_bwd")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")))


def _profile_group(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, norms, copies)"


def profile(fn, what: str) -> dict:
    """Trace one call of ``fn`` (warmed up) with ``torch.profiler``: device
    time by kernel group and the device's idle share over the call."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = {}          # kernel name -> [device ms, launches]
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = rows.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    busy = sum(ms for ms, _ in rows.values())
    if busy == 0:
        fail(f"the profile of {what} holds no device time")
    groups = {}
    for name, (ms, n) in rows.items():
        g = groups.setdefault(_profile_group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    log(f"  {what}: traced wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {max(0.0, 1 - busy / wall_ms):.4f}")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    {g:36s} {ms:10.3f} ms  {100 * ms / busy:6.2f} %  "
            f"{n} launches")
    log("  top kernels by device time:")
    for name, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {ms:10.3f} ms  {n:5d}x  {name[:100]}")
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy,
            "groups_ms": {g: v[0] for g, v in groups.items()},
            "groups_launches": {g: v[1] for g, v in groups.items()}}


def profile_step(eng) -> dict:
    """Trace one denoising step of the serving engine (the body of
    ``rollout_keyed``: velocity, then ``step_with_eps``) at batch 4."""
    prompts = synthetic_prompts(B_SERVE)
    cond = torch.from_numpy(eng.encode(prompts)).to(eng.device)
    draws = [request_draws(eng.adapter, s, NUM_STEPS, eng.device)
             for s in request_seeds(0, B_SERVE)]
    x = torch.stack([d[0] for d in draws])
    eps = torch.stack([d[1][0] for d in draws])
    ts = eng.scheduler.timesteps(NUM_STEPS)
    t, t_next = float(ts[0]), float(ts[1])
    tb = torch.full((B_SERVE,), t, device=eng.device)

    @torch.no_grad()
    def step():
        v = eng.adapter.velocity(eng.params, x, tb, cond).float()
        return eng.scheduler.step_with_eps(v, x, t, t_next, eps)

    return profile(step, f"one denoising step, batch {B_SERVE}, {SEQ} tokens")


# ------------------------------------------------------------------ phase 7
def check_modulated(eng, lat_zero: torch.Tensor) -> dict:
    """Serve the main path's requests again with the modulation drawn,
    through the engine and the kernels, and replay them through
    ``rollout_keyed`` on the plain versions."""
    draw_modulation(eng.params, eng.adapter.cfg.d_model, seed=2)
    prompts = synthetic_prompts(B_SERVE)
    lat = eng.serve(prompts, 0)          # the seed serve.main used
    cond = torch.from_numpy(eng.encode(prompts)).to(eng.device)
    with torch.no_grad(), plain_dispatch():
        ref_lat = rollout_keyed(eng.adapter, eng.params, cond,
                                request_seeds(0, B_SERVE), eng.scheduler,
                                NUM_STEPS).x0.cpu()
    err = float((lat - ref_lat).abs().max())
    scale = float(ref_lat.abs().max())
    moved = float((lat - lat_zero).abs().max())
    log(f"  {B_SERVE} requests served through the kernels vs rollout_keyed "
        f"through the plain versions: max|diff| {err:.3e} of max|x| "
        f"{scale:.3e}; the drawn modulation moved the latents by "
        f"{moved:.3e}")
    if not torch.isfinite(lat).all():
        fail("latents served with the drawn modulation are not finite")
    if err > BF16_BAND * scale:
        fail("served latents disagree with the plain replay")
    if moved <= 10 * err:
        fail("the drawn modulation hardly moved the latents; the replay "
             "check cannot see the blocks")
    return {"max_abs_err": err, "max_abs": scale, "moved": moved}


# ------------------------------------------------------------------ phase 8
TRAIN_LAYERS, TRAIN_STEPS, PROMPTS, GROUP = 4, 2, 2, 2
TRAIN_REWARDS = [{"reward_type": "text_render", "weight": 1.0},
                 {"reward_type": "pickscore", "weight": 0.25},
                 {"reward_type": "latent_norm", "weight": 0.1}]


class _Watch(loop_lib.Callback):
    """Keeps a copy of a few attention weights at train start, so the run
    can show that the params moved."""
    KEYS = ("wq", "wk", "wv")

    def on_train_start(self, loop):
        attn = loop.trainer.state.params["backbone"]["blocks"]["attn"]
        self.before = {k: attn[k].clone() for k in self.KEYS}


def train_path(tmp: str) -> dict:
    """``repro_torch.launch.train.main`` on the card: full-width flux_dit
    at 4 blocks, bf16, FLUX.1-dev geometry, flow_sde, T=4, 2 prompts x
    group 2, three rewards under gdpo, 2 steps."""
    argv = ["--arch", "flux_dit", "--sde", "flow_sde", "--device", "cuda",
            "--trainer", "flow_grpo", "--steps", str(TRAIN_STEPS),
            "--set", "arch_overrides=" + json.dumps(
                {"n_layers": TRAIN_LAYERS}),
            "--set", "param_dtype=bfloat16",
            "--set", f"flow.num_steps={NUM_STEPS}",
            "--set", f"flow.group_size={GROUP}",
            "--set", f"flow.latent_tokens={LAT_TOKENS}",
            "--set", f"flow.latent_dim={LAT_DIM}",
            "--set", "flow.advantage_agg=gdpo",
            "--set", "flow.rewards=" + json.dumps(TRAIN_REWARDS),
            "--set", f"flow.cache_dir={tmp}/cache",
            "--set", "data.encoder=" + json.dumps(
                {"cond_dim": COND_DIM, "cond_len": COND_LEN}),
            "--set", f"data.batch_prompts={PROMPTS}",
            "--set", f"data.n_prompts={PROMPTS * TRAIN_STEPS}",
            "--set", "loop.save_every=0", "--set", "loop.log_every=1",
            "--set", f"loop.ckpt_dir={tmp}/ckpt"]
    watch = _Watch()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = train.main(argv, callbacks=[watch])
    launches = counts()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    trainer = out["experiment"].build_trainer()
    n = TRAIN_STEPS
    want = {"sde_step": NUM_STEPS * n,
            "flash_attention": 2 * TRAIN_LAYERS * NUM_STEPS * n,
            "flash_attention_bwd": TRAIN_LAYERS * NUM_STEPS * n,
            "grpo_loss": NUM_STEPS * n, "grpo_loss_bwd": NUM_STEPS * n}
    log(f"  launches {launches} over {n} train steps (expected {want})")
    if launches != want:
        fail("the train path's kernel launches do not match the path")
    if len(hist) != n:
        fail(f"{len(hist)} train steps ran, expected {n}")
    for r in hist:
        vals = [r["loss"], r["grad_norm"], r["reward"]] + [
            v for k, v in r.items() if k.startswith("reward/")]
        if not all(math.isfinite(v) for v in vals):
            fail(f"train step {r['step']}: non-finite metrics {r}")
    attn = trainer.state.params["backbone"]["blocks"]["attn"]
    moved = {k: float((attn[k].float() - watch.before[k].float()).abs().max())
             for k in watch.KEYS}
    if int(trainer.state.opt.step) != n or not all(moved.values()):
        fail(f"the params did not move: step {int(trainer.state.opt.step)}, "
             f"max |change| {moved}")
    for r in hist:
        log(f"  step {r['step']}: {r['dt']:.4f} s (trainer.step through the "
            f"metrics fetch), loss {r['loss']:+.4e}, grad_norm "
            f"{r['grad_norm']:.4e}, reward {r['reward']:+.4e}, clip_frac "
            f"{r['clip_frac']:.3f}, max|logp_new - logp_old| "
            f"{r['logp_gap']:.4e} (clip_range {trainer.flow.clip_range})")
    log(f"  max_memory_allocated {peak / 2**30:.2f} GiB ({peak} bytes); "
        f"params moved by up to {moved}")
    res = {"launches": launches, "s_per_step": [r["dt"] for r in hist],
           "peak_bytes": peak,
           "clip_frac": [r["clip_frac"] for r in hist],
           "logp_gap": [r["logp_gap"] for r in hist],
           "loss": [r["loss"] for r in hist],
           "grad_norm": [r["grad_norm"] for r in hist],
           "reward": [r["reward"] for r in hist]}
    # one more train step of the same trainer, traced
    cond = torch.randn(PROMPTS, COND_LEN, COND_DIM, device=trainer.device)
    it = [n]

    def one_step():
        m = trainer.step(cond, 0, it=it[0])
        it[0] += 1
        return float(m["loss"])

    res["profile"] = profile(
        one_step, f"one train step, {PROMPTS} x {GROUP} samples, "
                  f"{TRAIN_LAYERS} blocks, {NUM_STEPS} timesteps")
    return res


# ------------------------------------------------------------------ phase 9
UPDATE_LAYERS, UPDATE_CLIP = 2, 0.2
# max |kernel - plain| / max |plain| of the attention weights' grads and the
# relative gap of grad_norm: two bf16 runs of the same step, each with its
# own rollout (latents 4e-3 apart after 4 steps, phase 7) and bf16 P and
# dS in the attention backward
GRAD_BAND = 5e-2


def check_update(dev) -> dict:
    """One update (rollout, rewards, loss and its gradient, clip, AdamW)
    at full width, depth 2, batch 2, with the modulation drawn, through
    the kernels and, on the same injected draws, through the plain
    versions.  The clip range is widened to 0.2 so that every sample's
    ratio lies inside the band on both routes (the kernel rollout's
    log-density differs from the loss's by the gap phase 8 prints)."""
    cfg = replace(configs.get("flux_dit"), n_layers=UPDATE_LAYERS)
    flow = FlowRLConfig(num_steps=NUM_STEPS, group_size=2,
                        clip_range=UPDATE_CLIP, latent_tokens=LAT_TOKENS,
                        latent_dim=LAT_DIM, advantage_agg="gdpo",
                        rewards=(RewardSpec("pickscore", 1.0, args={
                            "latent_dim": LAT_DIM, "cond_dim": COND_DIM}),
                                 RewardSpec("latent_norm", 0.1)))
    opt = OptimConfig(lr=1e-4, warmup_steps=1, total_steps=1000)
    gen = torch.Generator(device=dev).manual_seed(5)
    cond = torch.randn(1, COND_LEN, COND_DIM, generator=gen, device=dev)
    x_init = torch.randn(2, LAT_TOKENS, LAT_DIM, generator=gen, device=dev)
    eps = torch.randn(NUM_STEPS, 2, LAT_TOKENS, LAT_DIM, generator=gen,
                      device=dev)
    runs = {}
    params = None
    for route in ("kernel", "plain"):
        tr = FlowGRPOTrainer(cfg, flow, opt, seed=0, cond_dim=COND_DIM,
                             device=dev, params=params)
        if params is None:
            draw_modulation(tr.state.params, cfg.d_model, seed=6)
            params = _clone(tr.state.params)
        ctx = plain_dispatch() if route == "plain" else contextlib.nullcontext()
        with ctx:
            traj = tr.sample(tr.state.params, cond, None, x_init=x_init,
                             eps=eps)
            _, adv, stats = tr._rewards(traj.x0, {"cond": traj.cond})
            loss, aux = tr.backward(traj, adv)
            attn = tr.state.params["backbone"]["blocks"]["attn"]
            grads = {k: attn[k].grad.clone() for k in ("wq", "wk", "wv")}
            gnorm, lr = tr.apply_grads()
        torch.cuda.synchronize()
        runs[route] = {"loss": float(loss), "grad_norm": float(gnorm),
                       "lr": lr, "grads": grads,
                       "logp_gap": float(aux["logp_gap"]),
                       "reward": float(stats["reward_mean"]),
                       "adv_abs": float(adv.abs().mean()),
                       "params": tr.state.params}
        del tr, traj
        torch.cuda.empty_cache()
    k, p = runs["kernel"], runs["plain"]
    grad_err = {n: float((k["grads"][n].float() - p["grads"][n].float()
                          ).abs().max()) / float(p["grads"][n].float().abs(
                              ).max()) for n in k["grads"]}
    zero = [n for n, g in k["grads"].items() if not g.abs().max() > 0]
    gn_err = abs(k["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
    # AdamW's first step moves each weight by lr * g / (|g| + eps), ~lr
    # times the gradient's sign: where the two routes' gradients share it
    # the weights agree to their rounding; elsewhere they differ by 2 lr
    p_err, p_max, n_diff, n_all = 0.0, 0.0, 0, 0
    for (_, a), (_, b) in zip(params_lib.leaves(k["params"]),
                              params_lib.leaves(p["params"])):
        d = (a.float() - b.float()).abs()
        p_err = max(p_err, float(d.max()))
        p_max = max(p_max, float(b.float().abs().max()))
        n_diff += int((d > 0).sum())
        n_all += d.numel()
    ulp = 2.0 ** (math.floor(math.log2(p_max)) - 7)
    p_band = 2 * k["lr"] + ulp
    log(f"  one update, flux_dit depth {UPDATE_LAYERS}, batch 2, kernels vs "
        f"plain: loss {k['loss']:+.4e} / {p['loss']:+.4e}, grad_norm "
        f"{k['grad_norm']:.4e} / {p['grad_norm']:.4e} ({gn_err:.2e}), "
        f"reward {k['reward']:+.4e} / {p['reward']:+.4e}, max|logp_new - "
        f"logp_old| {k['logp_gap']:.3e} / {p['logp_gap']:.3e}")
    log(f"  grads of wq/wk/wv: max|kernel - plain| / max|plain| "
        f"{grad_err['wq']:.3e}/{grad_err['wk']:.3e}/{grad_err['wv']:.3e} "
        f"(band {GRAD_BAND}); params after AdamW: max|diff| {p_err:.3e} "
        f"(band 2 lr + one bf16 ulp of max|p| = {p_band:.3e}), "
        f"{n_diff} of {n_all} weights differ")
    if zero:
        fail(f"the gradients of {zero} are zero: the check cannot see the "
             "attention backward")
    if max(grad_err.values()) > GRAD_BAND or gn_err > GRAD_BAND:
        fail("the update's gradients through the kernels disagree with the "
             "plain versions")
    # inside the clip band each route's loss is -mean(ratio A) with
    # |ratio - 1| <= clip, so the two differ by at most 2 clip mean|A|
    loss_band = 2 * UPDATE_CLIP * max(k["adv_abs"], p["adv_abs"])
    if abs(k["loss"] - p["loss"]) > loss_band:
        fail("the update's loss through the kernels disagrees with the plain "
             f"versions beyond {loss_band:.3e}")
    if p_err > p_band:
        fail("the params after AdamW disagree between the routes")
    return {"grad_err": grad_err, "grad_norm_err": gn_err,
            "loss": [k["loss"], p["loss"]], "loss_band": loss_band,
            "param_max_diff": p_err,
            "param_band": p_band, "params_differing": n_diff,
            "params_total": n_all}


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="", metavar="N,N,...",
                    help="run only these of phases 3-9 after the device and "
                         "build phases, and print no result lines (a "
                         "development aid; the check runs every phase)")
    args = ap.parse_args(argv)
    only = {int(n) for n in args.only.split(",") if n}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the H100",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cap = torch.cuda.get_device_capability(dev)
    card = card_line()
    log(f"[1] device: {torch.cuda.get_device_name(dev)} capability {cap}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")
    log(card)
    if cap != (9, 0):
        fail(f"capability {cap}, the kernels are built for sm_90a")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"[2] build: {json.dumps(secs)} ({time.perf_counter() - t0:.2f} s "
        f"wall, one nvcc per source in parallel)")
    for name in _build.sources():
        _build.load(name)

    if only:
        return run_only(dev, only)

    log("[3] kernels against their plain versions")
    rows = [check_sde(dev), check_attention(dev), check_attention_bwd(dev),
            *check_grpo(dev)]

    log("[4] velocity at full width, depth 2")
    check_velocity(dev)
    torch.cuda.empty_cache()

    log("[5] main path: repro_torch.launch.serve, full flux_dit")
    res = main_path()
    eng, lat_zero = res.pop("engine"), res.pop("latents")

    log("[6] profile of one denoising step of the engine")
    res["profile"] = profile_step(eng)

    log("[7] drawn modulation: served through the kernels vs plain replay")
    res["modulated"] = check_modulated(eng, lat_zero)
    del eng, lat_zero
    gc.collect()
    torch.cuda.empty_cache()

    log(f"[8] train path: repro_torch.launch.train, flux_dit at full width, "
        f"{TRAIN_LAYERS} blocks")
    with tempfile.TemporaryDirectory() as tmp:
        train_res = train_path(tmp)
    gc.collect()
    torch.cuda.empty_cache()

    log("[9] one update through the kernels vs the plain versions")
    update_res = check_update(dev)

    for row in rows:
        row["launches"] = train_res["launches"][row["name"]]
        row["launches_by_path"] = {"serve": res["launches"][row["name"]],
                                   "train": row["launches"]}
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "launches_by_path")
    print(json.dumps({"main_path": {k: v for k, v in res.items()
                                    if k != "launches"}}))
    print(json.dumps({"train_path": {k: v for k, v in train_res.items()
                                     if k != "launches"},
                      "update_check": update_res}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _train_in_tmp() -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        return train_path(tmp)


def run_only(dev, only: set) -> int:
    phases = {3: lambda: [check_sde(dev), check_attention(dev),
                          check_attention_bwd(dev), *check_grpo(dev)],
              8: _train_in_tmp, 9: lambda: check_update(dev)}
    for n in sorted(only):
        if n not in phases:
            fail(f"--only: phase {n} cannot run alone")
        log(f"[{n}] (--only)")
        phases[n]()
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

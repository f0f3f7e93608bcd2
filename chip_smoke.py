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
   the serving path gives them and at small, odd, causal, windowed, GQA and
   ragged shapes; then the kernel, plain, bound and (for attention) SDPA
   times at the path shapes, with CUDA events.
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
8. A ``kernels`` JSON line, the card's name and power limit, and the last
   line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.config import FlowRLConfig, replace  # noqa: E402
from repro_torch.core.rollout import (  # noqa: E402
    request_draws, request_seeds, rollout_keyed)
from repro_torch.data import synthetic_prompts  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.sde_step import sde_step  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
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


@contextlib.contextmanager
def plain_dispatch():
    """Route ``ops`` to the plain versions on CUDA tensors too, for the
    comparison runs of this script (the port itself has no such switch)."""
    saved = ops._flash, ops._sde
    ops._flash = ref.flash_attention_ref
    ops._sde = lambda v, x, eps, t, t_next, eta: ref.sde_step_ref(
        v, x, t, t_next, eps, eta=eta)
    try:
        yield
    finally:
        ops._flash, ops._sde = saved


def reset_counts() -> None:
    sde_step.launches = 0
    flash_attention.launches = 0


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
    launches = {"sde_step": sde_step.launches,
                "flash_attention": flash_attention.launches}
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
PROFILE_GROUPS = (("flash_attention kernel", ("attn_fwd",)),
                  ("sde_step kernel", ("sde_step_chunks", "sde_logp_rows")),
                  ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass",
                                       "sm90_")))


def _profile_group(name: str) -> str:
    low = name.lower()
    for group, keys in PROFILE_GROUPS:
        if any(k in low for k in keys):
            return group
    return "other (elementwise, norms, copies)"


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

    def step():
        v = eng.adapter.velocity(eng.params, x, tb, cond).float()
        return eng.scheduler.step_with_eps(v, x, t, t_next, eps)

    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step()
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
        fail("the profile of one step holds no device time")
    groups = {}
    for name, (ms, n) in rows.items():
        g = groups.setdefault(_profile_group(name), [0.0, 0])
        g[0] += ms
        g[1] += n
    log(f"  one step, batch {B_SERVE}, {SEQ} tokens: traced wall "
        f"{wall_ms:.3f} ms, device busy {busy:.3f} ms, idle share "
        f"{max(0.0, 1 - busy / wall_ms):.4f}")
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    {g:36s} {ms:10.3f} ms  {100 * ms / busy:6.2f} %  "
            f"{n} launches")
    log("  top kernels by device time:")
    for name, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {ms:10.3f} ms  {n:5d}x  {name[:100]}")
    return {"traced_wall_ms": wall_ms, "device_busy_ms": busy,
            "groups_ms": {g: v[0] for g, v in groups.items()}}


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


def main() -> int:
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

    log("[3] kernels against their plain versions")
    rows = [check_sde(dev), check_attention(dev)]

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
    del eng
    for row in rows:
        row["launches"] = res["launches"][row["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"main_path": {k: v for k, v in res.items()
                                    if k != "launches"}}))
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

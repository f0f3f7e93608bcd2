"""Flow-matching sampling service of the port — a thin shell over the
serving engine (the port of ``repro.launch.serve``).

Requests go through :class:`repro_torch.serving.ServingEngine`.  Warmup
(one batch per bucket shape: on the GPU its eager run and the capture of
its CUDA graph) and the serve pass are timed separately; both timings end
in a host fetch of the latents, so they cover the device work.  A
steady-state serve that compiled (a cold dispatch) raises, as the
reference refuses it.

  # on the GPU (default)
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --sde flow_sde \\
      --requests 8 --set flow.num_steps=4

  # the same path on the CPU, through the kernels' plain versions
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \\
      --requests 3 --set flow.num_steps=2 \\
      --set 'data.encoder={"cond_dim":32,"cond_len":4,"vocab":256,"hidden":64}'

Sharded serving (``--set dist.data_parallel=N``, ``model_parallel``)
runs under ``torchrun`` as the train CLI does: every rank submits the
same requests, each runs its slice of every bucket, and rank 0 prints;
per-request latents are the one-device ones.

``main`` returns ``{"latents", "stats", "warmup", "warmup_s", "encode_s",
"serve_s", "engine"}`` for callers that drive it in-process.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import distributed
from repro_torch.api.experiment import Experiment, default_cli_config
from repro_torch.config import replace
from repro_torch.data import synthetic_prompts
from repro_torch.launch.train import _log, join_group


def serve_profile():
    """Serving defaults: deterministic ODE solver, small latent geometry."""
    cfg = default_cli_config()
    return replace(cfg, flow=replace(cfg.flow, sde_type="ode", eta=0.3))


def _int_list(raw: str, what: str, ap):
    try:
        vals = [int(b) for b in raw.split(",") if b] if raw else None
        if vals and any(v < 1 for v in vals):
            raise ValueError(f"{what} must be >= 1, got {vals}")
    except ValueError as e:
        ap.error(f"--{what}: {e}")
    return vals


def main(argv=None) -> dict:
    ap = Experiment.cli_parser("Flow-Factory sampling service (PyTorch)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--bucket", default="", metavar="B1,B2,...",
                    help="comma-separated batch bucket tiers "
                         "(default: powers of two up to --max-batch)")
    ap.add_argument("--deadline-ms", type=float, default=5.0,
                    help="max wait before a partial bucket is flushed")
    ap.add_argument("--step-tiers", default="", metavar="S1,S2,...",
                    help="admitted num_steps tiers (warmed and enforced at "
                         "submit; default: flow.num_steps only)")
    ap.add_argument("--stats-json", default="", metavar="PATH",
                    help="write the engine's JSON stats snapshot to PATH "
                         "after serving ('-' prints to stdout)")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if args.max_batch < 1:
        ap.error("--max-batch must be >= 1")
    buckets = _int_list(args.bucket, "bucket", ap)
    step_tiers = _int_list(args.step_tiers, "step-tiers", ap)
    created = join_group(args)
    try:
        return _serve(args, buckets, step_tiers)
    finally:
        if created:
            dist.destroy_process_group()


def _serve(args, buckets, step_tiers) -> dict:
    exp = Experiment.from_args(args, base=serve_profile())

    prompts = synthetic_prompts(args.requests)
    engine = exp.build_engine(max_batch=args.max_batch, buckets=buckets,
                              step_tiers=step_tiers,
                              deadline_s=args.deadline_ms / 1e3)

    t0 = time.perf_counter()
    report = engine.warmup()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.encode(prompts)               # encoder weights + cond-cache fill
    enc_s = time.perf_counter() - t0
    grid = " ".join(f"{k}={v:.2f}s" for k, v in sorted(report.items()))
    _log(f"warmup: compiled {len(report)} bucket shapes in {warm_s:.2f}s "
         f"({grid}); cond encode+cache {enc_s:.2f}s")

    t0 = time.perf_counter()
    latents = engine.serve(prompts, exp.cfg.seed)      # ends in a host fetch
    dt = max(time.perf_counter() - t0, 1e-9)
    s = engine.stats
    lat = latents.numpy()
    _log(f"steady-state: served {args.requests} requests in {dt:.3f}s "
         f"({args.requests / dt:.3f} req/s) on {exp.device}; latents "
         f"{tuple(lat.shape)}, rms={float(np.sqrt((lat ** 2).mean())):.3f}")
    _log(f"engine: buckets={s['buckets']} step_tiers={s['step_tiers']} "
         f"dispatches={s['dispatches']} padded_lanes={s['padded_lanes']} "
         f"compiles={s['compiles']} cold_dispatches={s['cold_dispatches']} "
         f"cond_cache={s['cond_cache']} data_parallel={s['data_parallel']} "
         f"model_parallel={s['model_parallel']}")
    graphs = engine.graph_report()
    if graphs["captures"]:
        _log(f"graphs: {graphs['captures']} captures, {graphs['replays']} "
             f"replays, pool {graphs['pool_bytes']} bytes, "
             f"max_memory_allocated "
             f"{torch.cuda.max_memory_allocated(engine.device)} bytes")
    if args.stats_json and distributed.is_main_process():
        payload = json.dumps(s, indent=2, sort_keys=True)
        if args.stats_json == "-":
            print(payload)
        else:
            with open(args.stats_json, "w") as f:
                f.write(payload + "\n")
            print(f"stats: wrote JSON snapshot to {args.stats_json}")
    if s["cold_dispatches"]:
        raise RuntimeError(f"steady-state serve hit a compile: "
                           f"{s['cold_dispatches']} cold dispatches")
    if not np.isfinite(lat).all():
        raise RuntimeError("served latents are not finite")
    return {"latents": latents, "stats": s, "warmup": report,
            "warmup_s": warm_s, "encode_s": enc_s, "serve_s": dt,
            "engine": engine}


if __name__ == "__main__":
    main()

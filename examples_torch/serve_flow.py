"""Serving example on the PyTorch port: the bucketed continuous-batching
engine with interchangeable backbones and solvers — the inference half of
the Experiment front door.

For each backbone × solver combination the engine is warmed (every bucket
shape run once and, on the GPU, captured as a CUDA graph; the warmup time
is reported separately), then a mixed request load — including repeat
prompts, which hit the cond-encoding cache — is served and steady-state
throughput printed.  Backbone and solver are registry names on the same
config.  The port of ``examples/serve_flow.py``, on the GPU unless
``--device cpu``:

  PYTHONPATH=src python examples_torch/serve_flow.py [--device cpu]
"""
import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.api import Experiment
from repro_torch.config import DataConfig, FlowRLConfig, RunConfig
from repro_torch.data import synthetic_prompts

ENCODER = dict(cond_dim=512, cond_len=8, vocab=4096, hidden=256)
ARCHS = ("flux_dit", "mamba2-370m")
SOLVERS = ("ode", "dance_sde")
SEED = 0


def make_config(arch_name: str, sde: str) -> RunConfig:
    return RunConfig(
        arch=arch_name, reduced=True,
        flow=FlowRLConfig(sde_type=sde, eta=0.3, num_steps=6,
                          latent_tokens=8, latent_dim=8,
                          preprocessing=False),
        data=DataConfig(encoder=ENCODER))


def make_exp(arch_name: str, sde: str, device=None) -> Experiment:
    return Experiment.from_config(make_config(arch_name, sde), device=device)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the example; returns, per ``(arch, solver)``, the engine, the
    served latents, the warmup and serve seconds and the engine's stats."""
    args = parse_args(argv)
    # a mixed load: 6 unique prompts, 2 repeats (cond-cache hits)
    prompts = synthetic_prompts(6) + synthetic_prompts(2)
    out: Dict[Any, Dict[str, Any]] = {}
    for arch_name in ARCHS:
        for sde in SOLVERS:
            exp = make_exp(arch_name, sde, device=args.device)
            engine = exp.build_engine(max_batch=4)
            t0 = time.perf_counter()
            engine.warmup()                  # every bucket shape, captured
            engine.encode(prompts)           # prime encoder + cache
            warm = time.perf_counter() - t0
            t0 = time.perf_counter()
            lat = engine.serve(prompts, SEED)    # latents on the host
            if engine.device.type == "cuda":
                torch.cuda.synchronize(engine.device)
            dt = time.perf_counter() - t0
            s = engine.stats
            rms = float(np.sqrt((lat.numpy() ** 2).mean()))
            print(f"{arch_name:14s} solver={sde:10s} "
                  f"{len(prompts)/dt:6.1f} req/s (warmup {warm:4.1f}s)  "
                  f"latent_rms={rms:.3f}  buckets={s['buckets']} "
                  f"cache_hits={s['cond_cache']['hits']}")
            assert s["cold_dispatches"] == 0
            out[(arch_name, sde)] = {"engine": engine, "latents": lat,
                                     "prompts": prompts, "warmup_s": warm,
                                     "serve_s": dt, "stats": s}
    return out


if __name__ == "__main__":
    main()

"""End-to-end run on the PyTorch port: preprocess a prompt corpus, then
RL fine-tune a ~100M-param FLUX-style DiT with Flow-GRPO, with full-state
checkpointing and a reward log — all from one declarative RunConfig (the
custom model size is plain ``arch_overrides`` data, not code).  The port of
``examples/train_grpo_e2e.py``: the same config through
``repro_torch.api.Experiment``, on the GPU unless ``--device cpu``.

Full run (~100M params, 200 steps, on the GPU):
  PYTHONPATH=src python examples_torch/train_grpo_e2e.py
CI-scale sanity run:
  PYTHONPATH=src python examples_torch/train_grpo_e2e.py --small --steps 10
"""
import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.api import Experiment
from repro_torch.config import (DataConfig, FlowRLConfig, LoopConfig,
                                OptimConfig, RewardSpec, RunConfig)

# ~100M-param member of the paper's DiT family, declared as data
MODEL_100M = {"n_layers": 12, "d_model": 768, "n_heads": 12,
              "n_kv_heads": 12, "d_ff": 3072, "head_dim": 64,
              "vocab_size": 4096}


def build_config(args) -> RunConfig:
    lat_tok, lat_dim = (8, 8) if args.small else (64, 16)
    return RunConfig(
        arch="flux_dit", reduced=args.small,
        arch_overrides={} if args.small else MODEL_100M,
        flow=FlowRLConfig(
            trainer_type="flow_grpo", sde_type="flow_sde", eta=0.7,
            num_steps=4 if args.small else 8,
            group_size=4, latent_tokens=lat_tok, latent_dim=lat_dim,
            advantage_agg="gdpo",
            rewards=(RewardSpec("text_render", 1.0),
                     RewardSpec("pickscore", 0.25),
                     RewardSpec("latent_norm", 0.1)),
            cache_dir=f"{args.out}/cache"),
        optim=OptimConfig(lr=3e-4, total_steps=args.steps,
                          warmup_steps=max(2, args.steps // 20)),
        data=DataConfig(n_prompts=64, batch_prompts=4),
        loop=LoopConfig(steps=args.steps, log_every=10, save_every=100,
                        ckpt_dir=f"{args.out}/ckpt",
                        log_file=f"{args.out}/reward_log.json"))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default="experiments/e2e")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    return ap.parse_args(argv)


def run(cfg: RunConfig, device: str = "cuda") -> Dict[str, Any]:
    """Train ``cfg`` and print what the reference's example prints; returns
    ``Experiment.train()``'s result with the experiment under
    ``"experiment"``."""
    exp = Experiment.from_config(cfg, device=device)
    d = exp.describe()
    print(f"[e2e] {d['trainer']['name']} on {d['arch']['name']} "
          f"({d['arch']['n_params']/1e6:.1f}M params), "
          f"rewards={d['rewards']}")
    out = {"experiment": exp, **exp.train()}
    hist = out["history"]
    if not hist:
        print("[done] nothing left to train (resumed at final step)")
        return out
    early = np.mean([r["reward"] for r in hist[:5]])
    late = np.mean([r["reward"] for r in hist[-5:]])
    print(f"[done] reward {early:+.4f} -> {late:+.4f} "
          f"({'improved' if late > early else 'no gain'})")
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the example (``run`` over the parsed arguments' config)."""
    args = parse_args(argv)
    return run(build_config(args), args.device)


if __name__ == "__main__":
    main()

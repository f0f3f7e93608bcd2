"""Multi-reward training on the PyTorch port (paper §2.3): pointwise +
groupwise rewards sharing one frozen backbone (deduplicated by
``model_id``), compared under weighted_sum vs GDPO advantage aggregation —
the aggregator is a single dotted override on the same Experiment config.
The port of ``examples/multi_reward.py``, on the GPU unless ``--device
cpu``:

  PYTHONPATH=src python examples_torch/multi_reward.py [--device cpu]
"""
import argparse
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.api import Experiment, apply_overrides
from repro_torch.config import (DataConfig, FlowRLConfig, LoopConfig,
                                OptimConfig, RewardSpec, RunConfig)

BASE = RunConfig(
    arch="flux_dit", reduced=True,
    flow=FlowRLConfig(
        num_steps=4, group_size=4, latent_tokens=8, latent_dim=8,
        rewards=(
            # pointwise preference scorer
            RewardSpec("pickscore", 0.5, model_id="pickscore-base"),
            # groupwise pairwise-preference reward SHARING the same backbone
            RewardSpec("pref_group", 0.5, model_id="pickscore-base"),
            # task reward + regularizer (latent geometry auto-completed)
            RewardSpec("text_render", 1.0),
            RewardSpec("latent_norm", 0.1)),
        preprocessing=True, cache_dir="cache/multi_reward"),
    optim=OptimConfig(lr=3e-4, total_steps=15, warmup_steps=2),
    data=DataConfig(n_prompts=16, batch_prompts=2,
                    encoder=dict(cond_dim=64, cond_len=4, vocab=512,
                                 hidden=128)),
    loop=LoopConfig(steps=15, log_every=0, save_every=0, resume=False))

AGGREGATIONS = ("weighted_sum", "gdpo")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=".",
                    help="directory the config's relative cache_dir is "
                         "under (default: the working directory)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the example; returns, per aggregation, the trainer's
    ``unique_loads`` and the run's history."""
    args = parse_args(argv)
    base = BASE
    if args.out != ".":
        base = apply_overrides(base, [
            f"flow.cache_dir={os.path.join(args.out, base.flow.cache_dir)}"])
    out: Dict[str, Any] = {}
    for agg in AGGREGATIONS:
        exp = Experiment.from_config(
            apply_overrides(base, [f"flow.advantage_agg={agg}"]),
            device=args.device)
        trainer = exp.build_trainer()
        print(f"\n[{agg}] {len(exp.flow.rewards)} reward configs -> "
              f"{trainer.loader.unique_loads} unique frozen models loaded "
              "(deduplication)")
        hist = exp.train()["history"]
        for row in hist[::5] + [hist[-1]]:
            per = {k.split('/')[-1]: round(v, 3) for k, v in row.items()
                   if k.startswith("reward/")}
            print(f"  step {row['step']:3d} total={row['reward']:+.4f} "
                  f"per-reward={per}")
        rewards = [r["reward"] for r in hist]
        print(f"  gain: {np.mean(rewards[-3:]) - np.mean(rewards[:3]):+.4f}")
        out[agg] = {"unique_loads": trainer.loader.unique_loads,
                    "history": hist}
    return out


if __name__ == "__main__":
    main()

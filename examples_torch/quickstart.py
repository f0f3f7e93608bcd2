"""Quickstart on the PyTorch port: one declarative config is the whole
experiment.

``RunConfig`` names every component — backbone, RL algorithm, SDE dynamics,
rewards, dataset — by its registry name; ``Experiment`` resolves them and
runs the shared TrainLoop (paper §2.1: any model × algorithm × reward ×
scheduler combination from config alone, O(M+N) integration cost).
Swapping the algorithm is a one-override change, shown at the end.  The
port of ``examples/quickstart.py``, on the GPU unless ``--device cpu``:

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import os
from typing import Any, Dict, Optional, Sequence

from repro_torch.api import Experiment, apply_overrides
from repro_torch.config import (DataConfig, FlowRLConfig, LoopConfig,
                                OptimConfig, RewardSpec, RunConfig)

CONFIG = RunConfig(
    arch="flux_dit", reduced=True,          # any zoo arch, CPU-scale variant
    flow=FlowRLConfig(
        trainer_type="flow_grpo",           # registry.names("trainer")
        sde_type="flow_sde",                # registry.names("scheduler")
        eta=0.7, num_steps=6, group_size=4,
        latent_tokens=8, latent_dim=8,
        advantage_agg="gdpo",               # weighted_sum | gdpo
        rewards=(RewardSpec("text_render", 1.0),    # args auto-completed
                 RewardSpec("latent_norm", 0.1)),
        preprocessing=True, cache_dir="cache/quickstart"),
    optim=OptimConfig(lr=3e-4, total_steps=10, warmup_steps=2),
    data=DataConfig(n_prompts=16, batch_prompts=2,
                    encoder=dict(cond_dim=64, cond_len=4, vocab=512,
                                 hidden=128)),
    loop=LoopConfig(steps=10, log_every=1, save_every=0, resume=False))


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--out", default=".",
                    help="directory the config's relative cache_dir is "
                         "under (default: the working directory)")
    return ap.parse_args(argv)


def with_out(cfg: RunConfig, out: str) -> RunConfig:
    """``cfg`` with its relative ``flow.cache_dir`` placed under ``out``."""
    if out == ".":
        return cfg
    return apply_overrides(
        cfg, [f"flow.cache_dir={os.path.join(out, cfg.flow.cache_dir)}"])


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the example; returns both runs' ``Experiment.train()`` results
    (``"flow_grpo"`` and ``"awm"``)."""
    args = parse_args(argv)
    cfg = with_out(CONFIG, args.out)
    result = Experiment.from_config(cfg, device=args.device).train()

    print("\nswap the algorithm with ONE override:")
    exp2 = Experiment.from_config(
        apply_overrides(cfg, ["flow.trainer_type=awm"]), device=args.device)
    result2 = exp2.train()
    m = result2["history"][-1]
    print(f"awm final step: reward={m['reward']:+.4f}")
    return {"flow_grpo": result, "awm": result2}


if __name__ == "__main__":
    main()

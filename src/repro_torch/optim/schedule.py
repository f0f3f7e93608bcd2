"""Learning-rate schedules — the port of ``repro.optim.schedule``.  The
schedule is a host function of the step counter, computed in f32 as the
reference computes it."""
from __future__ import annotations

import math

import numpy as np

from repro_torch.config import OptimConfig

F32 = np.float32


def make_schedule(cfg: OptimConfig):
    """Returns lr(step) -> float (an f32 value)."""
    if cfg.schedule == "constant":
        return lambda step: float(F32(cfg.lr))

    if cfg.schedule == "warmup_cosine":
        def lr(step):
            s = F32(int(step)) + F32(1.0)   # 0-based counter; never lr=0
            warm = min(s / F32(max(cfg.warmup_steps, 1)), F32(1.0))
            prog = np.clip((s - F32(cfg.warmup_steps))
                           / F32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                           F32(0.0), F32(1.0))
            cos = F32(0.5) * (F32(1.0) + np.cos(F32(math.pi) * prog,
                                                dtype=F32))
            return float(F32(cfg.lr) * warm * (F32(0.1) + F32(0.9) * cos))
        return lr

    raise ValueError(f"unknown schedule {cfg.schedule}")

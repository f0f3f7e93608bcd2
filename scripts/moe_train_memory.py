#!/usr/bin/env python3
"""Which memory measures ``deepseek-v2-236b``'s training needs on one H100.

    python3 scripts/moe_train_memory.py                 # every variant
    python3 scripts/moe_train_memory.py --without a,b   # one, in-process

Trains ``deepseek-v2-236b`` at full width and 2 layers (the dense one and
one MoE layer) exactly as ``chip_smoke.py``'s phase 30 does
(``chip_smoke.train_one``: ``launch.train`` under ``perf.remat=block``,
``flow_grpo``, 2 steps with its launch-count and gradient checks), with
one of the three measures that phase relies on taken away:

- ``expandable``: the caching allocator's expandable segments
  (``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` for the process,
  which ``chip_smoke.py`` sets for itself);
- ``flat_chunks``: AdamW over large leaves in flat chunks; without it,
  in leading-dim slices, which a one-layer stack cannot cut;
- ``offload``: the reward towers kept on the host between uses
  (``perf.offload_rewards``).

With no arguments every variant runs in a process of its own (the
allocator setting is read when CUDA starts) and one JSON line each is
printed: whether the two steps ran, with the peak memory allocated and
reserved over them and s per step, or the out-of-memory message with the
peaks up to it.  The card's name and
power limit are printed first.  Exits 2 without CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MEASURES = ("expandable", "flat_chunks", "offload")
VARIANTS = ((),) + tuple((m,) for m in MEASURES)


def _leading_dim_adamw(params, grads, state, cfg, scalars) -> None:
    """AdamW as it was before flat chunks: a large leaf in slices of its
    leading dim of at most ``CHUNK`` elements (a one-layer stack is one
    slice)."""
    import torch
    from repro_torch.models.params import leaves
    from repro_torch.optim import adamw

    with torch.no_grad():
        g_l, m_l, v_l = (dict(leaves(t))
                         for t in (grads, state.mu, state.nu))
        for path, p in leaves(params):
            g, m, v = g_l[path], m_l[path], v_l[path]
            if p.dim() == 0 or p.numel() <= adamw.CHUNK:
                adamw._adamw_slice(p, g, m, v, cfg, scalars)
                continue
            rows = max(1, adamw.CHUNK // (p.numel() // p.shape[0]))
            for r in range(0, p.shape[0], rows):
                adamw._adamw_slice(p[r:r + rows], g[r:r + rows],
                                   m[r:r + rows], v[r:r + rows], cfg,
                                   scalars)


def run_one(without: tuple) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch
    from repro_torch import optim

    if "flat_chunks" in without:
        optim.AdamW.apply = staticmethod(_leading_dim_adamw)
    extra = cs.BLOCK + ("--set", "perf.log_memory=true")
    if "offload" not in without:
        extra += ("--set", "perf.offload_rewards=true")
    kernels = ({"flash_attention": cs.DS_TRAIN_LAYERS},
               {"flash_attention_bwd": cs.DS_TRAIN_LAYERS})
    res = {"without": list(without),
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")}
    with tempfile.TemporaryDirectory() as tmp:
        try:
            row, _ = cs.train_one(
                tmp, cs.DS_ARCH, cs.DS_TRAIN_LAYERS, cs.HY_COND_LEN,
                kernels, cs._ds_watch(), "flow_grpo", cs.TRAIN_STEPS,
                extra=extra, tag="block", remat="block",
                routes=cs.MOE_ROUTES)
            res.update(ok=True, s_per_step=row["s_per_step"],
                       peak_allocated_gib=row["peak_bytes"] / 2 ** 30,
                       peak_reserved_gib=row["peak_reserved_bytes"] / 2 ** 30)
        except torch.OutOfMemoryError as e:
            res.update(
                ok=False, error=str(e)[:400],
                peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                peak_reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--without", default=None,
                    help="comma-separated measures to take away "
                         f"({', '.join(MEASURES)}); runs in this process")
    args = ap.parse_args(argv)
    if args.without is not None:
        without = tuple(w for w in args.without.split(",") if w)
        bad = set(without) - set(MEASURES)
        if bad:
            ap.error(f"unknown measures {sorted(bad)}")
        print("RESULT " + json.dumps(run_one(without)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("moe_train_memory: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    ok = True
    for without in VARIANTS:
        env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:"
                   + str("expandable" not in without))
        p = subprocess.run([sys.executable, __file__, "--without",
                            ",".join(without)], env=env,
                           capture_output=True, text=True)
        lines = [ln[7:] for ln in p.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if p.returncode or not lines:
            ok = False
            print(json.dumps({"without": list(without), "ok": False,
                              "rc": p.returncode,
                              "error": (p.stdout + p.stderr)[-1500:]}),
                  flush=True)
        else:
            print(lines[-1], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

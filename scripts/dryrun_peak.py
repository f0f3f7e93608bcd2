#!/usr/bin/env python3
"""What is live at a dry-run step's peak, by the op that made it and its
shape.

    PYTHONPATH=src python3 scripts/dryrun_peak.py \\
        --arch grok-1-314b --shape train_4k

Runs the step ``python -m repro_torch.launch.dryrun`` runs for the pair
on the 16 x 16 production mesh (rank 0 of a fake group, meta tensors, no
device) under the dry run's own memory tracker, and at the step's peak
sums the live storages by (op, shape, dtype).  Prints the peak and the
arguments' bytes, then the ``--top`` largest groups, in GB, each with its
count of storages.  The fake
group is global to its process: one pair a process.

With ``--prefill L`` it runs instead, on one card with no mesh, the LM
prefill step (``tasks.make_prefill_step``) of ``--arch`` at batch 1 over
L tokens at ``tasks.effective_window`` of that prefill shape (or
``--window``), ``--layers`` deep (default: all), in ``--dtype``; with
``--forward`` the plain ``Backbone.forward_embeds`` and the last 128
positions' logits instead (chip_smoke.py phase 44's exact check):

    PYTHONPATH=src python3 scripts/dryrun_peak.py --arch zamba2-2.7b \
        --prefill 524160 --layers 12
"""
from __future__ import annotations

import argparse
from collections import Counter


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--prefill", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--forward", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.utils._pytree import tree_leaves
    from repro_torch import configs
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.launch import dryrun, hlo_stats, specs

    class Tracker(dryrun.MemoryTracker):
        """The dry run's tracker, naming each storage it counts and
        keeping the live ones at the peak."""

        def __init__(self, base):
            super().__init__(base)
            self.made, self.at_peak = {}, {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before, peak = set(self._tracked), self.peak
            out = super().__torch_dispatch__(func, types, args, kwargs)
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.device.type == "meta":
                    key = id(t.untyped_storage())
                    if key in self._tracked and key not in before:
                        self.made[key] = (func.overloadpacket.__name__,
                                          tuple(t.shape), str(t.dtype))
            if self.peak > peak:     # storage ids are reused: name now
                self.at_peak = {k: (n, self.made.get(k))
                                for k, n in self._tracked.items()}
            return out

    if args.prefill:
        fn, step_args = _prefill(args)
        args.shape = f"prefill over {args.prefill} tokens"
    else:
        mesh, _, _ = dryrun._mesh(False, False)
        fn, step_args = specs.build_step(configs.get(args.arch),
                                         INPUT_SHAPES[args.shape], mesh)
    base = sum(dryrun._meta_storages(step_args).values())
    tracker = Tracker(base)
    with hlo_stats.record_collectives(), tracker:
        fn(*step_args)
    groups, count = Counter(), Counter()
    for nbytes, what in tracker.at_peak.values():
        groups[what] += nbytes
        count[what] += 1
    print(f"{args.arch} {args.shape}: peak {tracker.peak / 1e9:.2f} GB, "
          f"arguments {base / 1e9:.2f} GB")
    for what, nbytes in groups.most_common(args.top):
        print(f"  {nbytes / 1e9:8.2f} GB  {count[what]:5d} x {what}")


def _prefill(args):
    """(step, arguments) of ``--prefill``: the prefill (or the forward)
    on meta tensors, no mesh."""
    import torch
    from repro_torch import configs
    from repro_torch.config import InputShape, replace
    from repro_torch.models import params as params_lib
    from repro_torch.models import tasks
    from repro_torch.models.backbone import Backbone

    cfg = configs.get(args.arch)
    if args.layers:
        cfg = replace(cfg, n_layers=args.layers)
    window = args.window if args.window is not None else \
        tasks.effective_window(cfg, InputShape("prefill", args.prefill, 1,
                                               "prefill"))
    p = params_lib.init(Backbone(cfg).spec(), None,
                        getattr(torch, args.dtype), "meta")
    tokens = torch.zeros((1, args.prefill), dtype=torch.int32,
                         device="meta")
    if not args.forward:
        step = tasks.make_prefill_step(cfg, window=window)
        return (lambda p, t: step(p, {"tokens": t})), (p, tokens)
    model = Backbone(cfg)

    @torch.no_grad()
    def forward(p, t):
        hidden = model.forward_embeds(p, model.embed_inputs(p, t),
                                      window=window)
        return model.logits(p, hidden[:, -128:])
    return forward, (p, tokens)


if __name__ == "__main__":
    main()

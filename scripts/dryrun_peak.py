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
"""
from __future__ import annotations

import argparse
from collections import Counter


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--top", type=int, default=12)
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


if __name__ == "__main__":
    main()

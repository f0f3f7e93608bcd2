#!/usr/bin/env python3
"""The collectives of one dry-run step under the production layout, by
kind and mesh axis.

    PYTHONPATH=src python3 scripts/layout_collectives.py \\
        --arch deepseek-v2-236b --shape train_4k

Builds the step ``python -m repro_torch.launch.dryrun`` runs for the pair
on the 16 x 16 production mesh (rank 0 of a fake group of 256, meta
tensors, no device) and runs it once, recording each collective the port
runs with the mesh axis of its group ("data" or "model"; "world" for
any other group).  Prints one JSON line: for each (kind, axis) the count
and the link bytes a rank (``launch.hlo_stats``' ring formula, the dry
run's), and their totals.  The fake group is global to its process, so
run one pair a process.  With ``PYTHONPATH`` pointed at another
checkout's ``src`` the same script counts that checkout's step.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args()

    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch import sharding as shlib
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.launch import dryrun, hlo_stats, specs

    mesh, _, _ = dryrun._mesh(False, False)
    axes = {id(mesh.get_group(a)): a for a in ("data", "model")}
    stats = defaultdict(lambda: {"count": 0, "moved_bytes": 0.0})
    note = shlib._note

    def record(kind, result, group, n=0):
        g = n or dist.get_world_size(group)
        s = stats[f"{kind} {axes.get(id(group), 'world')}"]
        s["count"] += 1
        s["moved_bytes"] += hlo_stats._moved_bytes(
            kind, result.numel() * result.element_size(), g)
        note(kind, result, group, n)

    shlib._note = record
    fn, step_args = specs.build_step(configs.get(args.arch),
                                     INPUT_SHAPES[args.shape], mesh)
    dryrun.measure(fn, step_args)
    out = dict(sorted(stats.items()))
    out["_total"] = {f: sum(v[f] for v in stats.values())
                     for f in ("count", "moved_bytes")}
    print(json.dumps({"arch": args.arch, "shape": args.shape,
                      "mesh": "pod16x16", "collectives": out}))


if __name__ == "__main__":
    main()

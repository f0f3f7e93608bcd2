"""Dry run: run every (architecture × input-shape) pair's step on meta
tensors, with NO device memory (the port of ``repro.launch.dryrun``).

The step is the port's own program (``launch.specs``): its state and
inputs are this rank's shards on ``device="meta"``, every op runs for its
shapes and dtypes only, and each hand-written kernel's wrapper takes its
meta route (the card route's checks and buffers, no launch).  On a
production mesh (256 or 512 ranks) the process joins a ``fake`` process
group of that size as rank 0 (``launch.mesh.fake_group``), whose
collectives move nothing; ``--one-rank`` runs the exact single-device
path, no mesh and no collective.

Per pair it records to experiments/dryrun/<arch>__<shape>__<mesh>.json:
  * memory — bytes per rank: the arguments (state and inputs on the
    device), the outputs, the state (host step counter included), and the
    peak of live meta storages over the step (a ``TorchDispatchMode``
    that counts each storage an op creates until it is freed; ``temp`` is
    peak − arguments).  The reference reads XLA's ``memory_analysis()``.
  * analytic — the cost model (``launch.costs``).
  * collectives — every collective the step issued, per kind, with the
    reference's ring factors (``launch.hlo_stats``), and op_histogram,
    the aten ops it dispatched.
  * run_s — the seconds of the meta pass, in place of the reference's
    ``lower_s`` / ``compile_s`` (the port has no compile step).
  * layout — the layout the step ran under (``specs.layout``): the
    reference's production layout (rule tables, tensor parallel over
    "model", ZeRO-3 over "data"; see ``launch.specs``), whether the
    weights shard over "data" (``fsdp``), and the differences by
    construction; route: ``"weights"`` (each matrix's "data" shard
    gathered at use) or ``"activations"`` (decode always, train and
    prefill under ``REPRO_NO_WEIGHT_GATHER``: each product gathers its
    rows instead; ``launch.sweep --env REPRO_NO_WEIGHT_GATHER=1 --variant
    nwg`` names those records ``__nwg``).

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --flow-rl
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --one-rank
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from typing import Dict, Union

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch import sharding as shlib
from repro_torch.config import INPUT_SHAPES, InputShape
from repro_torch.launch import costs as costs_lib
from repro_torch.launch import hlo_stats
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs


def _meta_storages(tree) -> Dict[int, int]:
    """{id(storage): bytes} of the distinct meta storages in ``tree``."""
    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and t.device.type == "meta":
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def _nbytes(tree) -> int:
    """Bytes of the distinct storages in ``tree``, meta and host alike."""
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
    return total


class MemoryTracker(TorchDispatchMode):
    """Live bytes of meta storages: each storage an op returns that none
    of its inputs held is counted from then until it is freed (a weakref
    finaliser).  ``peak`` is the most live at once, on top of ``base``
    (the arguments, held throughout)."""

    def __init__(self, base: int = 0):
        super().__init__()
        self.live = self.peak = base
        self._tracked: Dict[int, int] = {}

    def _free(self, key: int) -> None:
        self.live -= self._tracked.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = _meta_storages((args, kwargs))
        for t in tree_leaves(out):
            if not (isinstance(t, torch.Tensor) and t.device.type == "meta"):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in inputs or key in self._tracked:
                continue
            self._tracked[key] = st.nbytes()
            weakref.finalize(st, self._free, key)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        return out


def measure(fn, args) -> Dict:
    """Run ``fn(*args)`` on meta tensors once: memory (bytes per rank),
    collectives, op histogram and the seconds it took."""
    arg_bytes = sum(_meta_storages(args).values())
    tracker = MemoryTracker(arg_bytes)
    t0 = time.perf_counter()
    with hlo_stats.record_collectives() as records, \
            hlo_stats.record_ops() as ops, tracker:
        out = fn(*args)
    run_s = time.perf_counter() - t0
    out_ids = _meta_storages(out)
    return {"memory": {"argument_bytes": arg_bytes,
                       "output_bytes": sum(out_ids.values()),
                       "temp_bytes": tracker.peak - arg_bytes,
                       "peak_bytes": tracker.peak},
            "collectives": hlo_stats.collective_bytes(records),
            "op_histogram": hlo_stats.op_histogram(ops),
            "run_s": run_s}


def _mesh(multi_pod: bool, one_rank: bool):
    """(mesh, name, ranks): the production mesh over a fake group of its
    size (joined here if no group exists), or no mesh."""
    if one_rank:
        return None, "rank1", 1
    data, model = mesh_lib.production_shape(multi_pod)
    if not dist.is_initialized():
        mesh_lib.fake_group(data * model)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")
    return mesh, ("pod2x16x16" if multi_pod else "pod16x16"), data * model


def run_one(arch: str, shape: Union[str, InputShape], *,
            multi_pod: bool = False, one_rank: bool = False,
            flow_rl: bool = False, out_dir: str = "experiments/dryrun",
            variant: str = "baseline", cfg=None) -> dict:
    """Dry-run one pair and write its record; ``cfg`` replaces
    ``configs.get(arch)`` (a cut depth), ``shape`` is a name of
    ``INPUT_SHAPES`` or an ``InputShape``."""
    cfg = cfg or configs.get(arch)
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    mesh, mesh_name, n_ranks = _mesh(multi_pod, one_rank)
    if flow_rl:
        fn, args = specs.build_flow_step(cfg, mesh)
        batch = specs.FLOW_PROMPTS * specs.FLOW_GROUP
        fsdp = True
        route = "activations" if shlib.no_weight_gather() else "weights"
    else:
        route = specs.step_route(shape)
        fn, args = specs.build_step(cfg, shape, mesh)
        batch = shape.global_batch
        fsdp = shape.kind == "train" or (
            mesh is not None and specs.inference_fsdp(cfg, mesh))
    res = measure(fn, args)
    # the first argument is the state (train) or the params (serving)
    res["memory"]["state_bytes"] = _nbytes(args[0])
    analytic = (costs_lib.step_costs(cfg, shape).asdict()
                if not flow_rl else {})
    record = {
        "arch": arch,
        "shape": shape.name if not flow_rl else "flow_rl_update",
        "mesh": mesh_name,
        "variant": variant,
        "n_devices": n_ranks,
        "kind": "flow_rl" if flow_rl else shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "n_layers": cfg.n_layers,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "layout": specs.layout(mesh, batch, fsdp=fsdp, cache_seq=(
            specs.cache_rules(cfg, shape, mesh).arules["cache_seq"]
            if shape.kind == "decode" and mesh is not None and not flow_rl
            else None), route=route),
        "fsdp": fsdp,
        "route": route,
        "run_s": round(res["run_s"], 2),
        "memory": res["memory"],
        "fits_80gb": res["memory"]["peak_bytes"] <= mesh_lib.HBM_BYTES,
        "analytic": analytic,
        "collectives": res["collectives"],
        "op_histogram": res["op_histogram"],
    }
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{variant}" if variant != "baseline" else ""
    path = os.path.join(out_dir,
                        f"{arch}__{record['shape']}__{mesh_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS
                    + configs.PAPER_ARCHS)
    ap.add_argument("--shape", default="train_4k",
                    choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--one-rank", action="store_true",
                    help="the single-device layout (no mesh) instead of a "
                         "production mesh")
    ap.add_argument("--flow-rl", action="store_true",
                    help="run the paper's GRPO update step instead of the "
                         "LM step")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args()

    try:
        rec = run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                      one_rank=args.one_rank, flow_rl=args.flow_rl,
                      out_dir=args.out_dir, variant=args.variant)
    except Exception:
        traceback.print_exc()
        sys.exit(1)

    print(json.dumps({k: rec[k] for k in
                      ("arch", "shape", "mesh", "run_s", "memory",
                       "fits_80gb", "collectives")}, indent=1))


if __name__ == "__main__":
    main()

"""Config-grid sweeps over the Experiment front door — the port of
``repro.launch.sweep``.

Default (``train``) mode: expand a config grid of dotted overrides and run
every combination through ``repro_torch.launch.train`` in a fresh
subprocess (a clean CUDA context per run), resumable — combos with an
existing artifact JSON are skipped.  ``--device`` is passed through
(default ``cuda``, as every entry point of the port; ``cpu`` rehearses the
sweep on the host).  The subprocess's ``PYTHONPATH`` is this checkout's
``src`` as an absolute path, so the sweep runs from any directory.

  PYTHONPATH=src python -m repro_torch.launch.sweep --reduced --steps 4 \\
      --grid flow.trainer_type=flow_grpo,awm --grid flow.eta=0.3,0.7

``--mode dryrun`` runs the (arch × shape × mesh) dry-run matrix through
``repro_torch.launch.dryrun``, one subprocess a pair (``--meshes``:
``single`` is one pod of 16 x 16 ranks, ``multi`` two).
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

from repro_torch import configs
from repro_torch.config import INPUT_SHAPES

OUT_DIR = "experiments/dryrun"
TRAIN_OUT_DIR = "experiments/sweep"
# this checkout's src/, for the subprocesses
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MESH_NAMES = {"single": "pod16x16", "multi": "pod2x16x16"}


# ---------------------------------------------------------------- train grid

def grid_combos(grid_specs):
    """``["a=1,2", "b=x"]`` -> [{"a":"1","b":"x"}, {"a":"2","b":"x"}]."""
    axes = []
    seen = set()
    for spec in grid_specs:
        path, _, vals = spec.partition("=")
        if not vals:
            raise SystemExit(f"bad --grid {spec!r}: expected PATH=V1,V2,...")
        if path in seen:   # dict(combo) would silently drop the first axis
            raise SystemExit(f"duplicate --grid axis {path!r}: merge the "
                             "values into one PATH=V1,V2,... spec")
        seen.add(path)
        axes.append([(path, v) for v in vals.split(",")])
    return [dict(combo) for combo in itertools.product(*axes)]


def combo_slug(combo) -> str:
    return "__".join(f"{p.replace('.', '_')}={v}" for p, v in
                     sorted(combo.items())) or "base"


def run_train_combo(combo, args) -> dict:
    slug = combo_slug(combo)
    art = os.path.join(TRAIN_OUT_DIR, slug + ".json")
    if os.path.exists(art):
        return {"skipped": True}
    cmd = [sys.executable, "-m", "repro_torch.launch.train",
           "--device", args.device]
    if args.steps is not None:           # None: respect the config's steps
        cmd += ["--steps", str(args.steps)]
    if args.config:
        cmd += ["--config", args.config]
    if args.reduced:
        cmd.append("--reduced")
    for path, val in combo.items():
        cmd += ["--set", f"{path}={val}"]
    cmd += ["--set", f"loop.log_file={art}",
            "--set", f"loop.ckpt_dir={os.path.join(TRAIN_OUT_DIR, slug)}"]
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=args.timeout, env=env, cwd=os.getcwd())
    ok = r.returncode == 0 and os.path.exists(art)
    return {"ok": ok, "wall_s": round(time.time() - t0, 1),
            "stderr_tail": r.stderr[-2000:] if not ok else ""}


# ------------------------------------------------------------- dryrun matrix

def artifact_path(arch: str, shape: str, mesh: str,
                  variant: str = "baseline") -> str:
    """The dry-run record of a pair; ``mesh`` a key of ``MESH_NAMES``."""
    mesh = MESH_NAMES[mesh]
    suffix = f"__{variant}" if variant != "baseline" else ""
    return os.path.join(OUT_DIR, f"{arch}__{shape}__{mesh}{suffix}.json")


def run_pair(arch: str, shape: str, mesh: str, *, timeout: int = 3600,
             variant: str = "baseline", extra_env=None) -> dict:
    path = artifact_path(arch, shape, mesh, variant)
    if os.path.exists(path):
        with open(path) as f:
            return {"skipped": True, **json.load(f)}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--variant", variant,
           "--out-dir", OUT_DIR]
    if mesh == "multi":
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=SRC)
    if extra_env:
        env.update(extra_env)
    t0 = time.time()
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=os.getcwd())
    ok = r.returncode == 0 and os.path.exists(path)
    return {"ok": ok, "wall_s": round(time.time() - t0, 1),
            "stderr_tail": r.stderr[-2000:] if not ok else ""}


def _report(results) -> None:
    n_fail = sum(1 for _, r in results if not (r.get("ok") or
                                               r.get("skipped")))
    print(f"\nsweep done: {len(results)} runs, {n_fail} failures")
    sys.exit(1 if n_fail else 0)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="train", choices=["train", "dryrun"])
    # train-grid mode
    ap.add_argument("--grid", action="append", default=[],
                    metavar="DOTTED.PATH=V1,V2",
                    help="sweep axis of --set overrides (repeatable)")
    ap.add_argument("--config", default="", help="base RunConfig JSON")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=None,
                    help="override steps per combo (default: the config's)")
    ap.add_argument("--device", default="cuda",
                    help="passed to each combo's launch.train")
    # dryrun mode
    ap.add_argument("--archs", default=",".join(configs.ARCH_IDS))
    ap.add_argument("--shapes", default=",".join(INPUT_SHAPES))
    ap.add_argument("--meshes", default="single,multi",
                    help=f"of {sorted(MESH_NAMES)}")
    ap.add_argument("--timeout", type=int, default=5400)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--env", default="",
                    help="comma-separated KEY=VAL extra env for dryrun")
    args = ap.parse_args()

    results = []
    if args.mode == "train":
        os.makedirs(TRAIN_OUT_DIR, exist_ok=True)
        for combo in grid_combos(args.grid):
            tag = combo_slug(combo)
            try:
                r = run_train_combo(combo, args)
            except subprocess.TimeoutExpired:
                r = {"ok": False, "stderr_tail": "TIMEOUT"}
            status = ("skip" if r.get("skipped")
                      else "ok" if r.get("ok") else "FAIL")
            print(f"[{status}] {tag}"
                  + (f"  ({r['wall_s']}s)" if "wall_s" in r else "")
                  + ("\n" + r.get("stderr_tail", "")
                     if status == "FAIL" else ""), flush=True)
            results.append((tag, r))
        _report(results)

    extra_env = dict(kv.split("=", 1) for kv in args.env.split(",") if kv)
    for arch in args.archs.split(","):
        for shape in args.shapes.split(","):
            for mesh in args.meshes.split(","):
                tag = f"{arch} × {shape} × {MESH_NAMES[mesh]}"
                try:
                    r = run_pair(arch, shape, mesh, timeout=args.timeout,
                                 variant=args.variant, extra_env=extra_env)
                except subprocess.TimeoutExpired:
                    r = {"ok": False, "stderr_tail": "TIMEOUT"}
                if r.get("skipped"):
                    print(f"[skip] {tag}", flush=True)
                elif r.get("ok"):
                    print(f"[ok]   {tag}  ({r['wall_s']}s)", flush=True)
                else:
                    print(f"[FAIL] {tag}\n{r.get('stderr_tail', '')}",
                          flush=True)
                results.append((tag, r))
    _report(results)


if __name__ == "__main__":
    main()

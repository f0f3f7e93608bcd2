"""Flow-Factory training launcher of the port — a thin shell over the
Experiment API (the port of ``repro.launch.train``).

One declarative :class:`RunConfig` drives both phases (paper §2.2):
preprocess-and-cache the prompt corpus, then RL fine-tune the selected
backbone through the shared :class:`repro_torch.api.TrainLoop` with
full-state checkpointing (params + AdamW moments) and auto-resume.  The run
is on ``--device`` (default ``cuda``; without a CUDA device that default
raises).

  # on the GPU (default)
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 2

  # the same path on the CPU, through the kernels' plain versions
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --steps 2 --set flow.num_steps=2 --set flow.group_size=2 \\
      --set 'data.encoder={"cond_dim":32,"cond_len":4,"vocab":256,"hidden":64}' \\
      --set flow.cache_dir=/tmp/v_cache --set loop.ckpt_dir=/tmp/v_ckpt

The perf policies and the pipelined loop take the reference's switches
(``--set perf.remat=block``, ``perf.fuse_step``, ``perf.policy_dtype``,
``perf.offload_rewards``, ``perf.remat=scan --set perf.remat_offload=true``,
``perf.log_memory``, ``loop.pipeline=N``); a non-default policy prints the
reference's ``[perf]`` banner, and ``perf.log_memory`` one ``[perf]`` line
per ``memory_stats`` entry before training.

Multi-rank runs (``dist.*``) go through ``torchrun``: each process reads
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``, joins the group (NCCL on
``cuda``, each rank on ``cuda:LOCAL_RANK``; gloo on ``--device cpu``) and
rank 0 prints, logs and checkpoints.  ``dp x mp`` above the world size
raises the reference's error with a launch hint:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --device cpu --reduced --steps 2 --set dist.data_parallel=2 \
      --set dist.model_parallel=2 --set flow.num_steps=2 \
      --set flow.group_size=2 \
      --set 'data.encoder={"cond_dim":32,"cond_len":4,"vocab":256,"hidden":64}' \
      --set flow.cache_dir=/tmp/v_cache --set loop.ckpt_dir=/tmp/v_ckpt_dist

``main`` takes extra TrainLoop callbacks (and ``mesh``, injected in place
of the one ``dist`` resolves to) and returns ``Experiment.train``'s
result plus the ``experiment`` and the ``memory_stats`` it printed (None
without ``perf.log_memory``), for callers that drive it in-process.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch import distributed
from repro_torch.api import Experiment
from repro_torch.device import resolve_device


def _pretty(mem: dict) -> str:
    return " ".join(
        f"{k[:-len('_bytes')]}={v / 1e6:.2f}MB"
        if k.endswith("_bytes") and isinstance(v, (int, float))
        else f"{k}={v}" for k, v in mem.items() if v is not None)


def _log(msg: str) -> None:
    if distributed.is_main_process():
        print(msg, flush=True)


def join_group(ns) -> bool:
    """Join the ``torchrun`` group if the environment describes one, and
    point ``ns.device`` at this rank's device.  True when this call
    created the group (the caller destroys it)."""
    created = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    ns.device = str(distributed.init_from_env(resolve_device(ns.device)))
    return created


def main(argv=None, callbacks=(), mesh=None) -> dict:
    ns = Experiment.cli_parser().parse_args(argv)
    created = join_group(ns)
    try:
        exp = Experiment.from_args(ns)
        exp.mesh = mesh
        return _main(exp, callbacks)
    finally:
        if created:
            dist.destroy_process_group()


def _main(exp, callbacks) -> dict:
    d = exp.describe()
    dd = d["dist"]
    if (dd["data_parallel"], dd["model_parallel"], dd["microbatch"]) != \
            (1, 1, 0):
        _log(f"[dist] data_parallel={dd['data_parallel']} model_parallel="
             f"{dd['model_parallel']} microbatch={dd['microbatch']} over "
             f"{dd['devices']} rank(s)")
    _log(f"[train] {d['trainer']['name']} on {d['arch']['name']} "
         f"({d['arch']['n_params'] / 1e6:.1f}M params), "
         f"sde={d['scheduler']['name']}, rewards={d['rewards']}, "
         f"device={d['device']}")
    p = exp.cfg.perf
    if exp.cfg.loop.pipeline != 1:
        _log(f"[perf] loop.pipeline={exp.cfg.loop.pipeline} "
             "(metrics drain up to pipeline-1 steps late; computation "
             "is unchanged)")
    if p != type(p)():
        _log(f"[perf] remat={p.remat} fuse_step={p.fuse_step}"
             + (f" policy_dtype={p.policy_dtype}" if p.policy_dtype else "")
             + (" offload_rewards=true" if p.offload_rewards else "")
             + (" remat_offload=true" if p.remat_offload else ""))
    mem_stats = None
    if p.log_memory:
        tr = exp.build_trainer()
        cond = torch.zeros((exp.cfg.data.batch_prompts, exp.cond_len,
                            exp.cond_dim), device=exp.device)
        mem_stats = tr.memory_stats(cond)
        for name, mem in mem_stats.items():
            _log(f"[perf] {name} memory_stats: {_pretty(mem)}")
    result = exp.train(callbacks)
    hist = result["history"]
    if hist:
        _log(f"[train] steps {result['start_step']}..{result['final_step']}"
             f"; reward {hist[0]['reward']:+.4f} -> "
             f"{hist[-1]['reward']:+.4f}")
    result["experiment"] = exp
    result["memory_stats"] = mem_stats
    return result


if __name__ == "__main__":
    main()

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

``main`` takes extra TrainLoop callbacks and returns ``Experiment.train``'s
result plus the ``experiment``, for callers that drive it in-process.
"""
from __future__ import annotations

from repro_torch.api import Experiment


def main(argv=None, callbacks=()) -> dict:
    exp = Experiment.from_cli(argv)
    d = exp.describe()
    print(f"[train] {d['trainer']['name']} on {d['arch']['name']} "
          f"({d['arch']['n_params'] / 1e6:.1f}M params), "
          f"sde={d['scheduler']['name']}, rewards={d['rewards']}, "
          f"device={d['device']}", flush=True)
    result = exp.train(callbacks)
    hist = result["history"]
    if hist:
        print(f"[train] steps {result['start_step']}..{result['final_step']}"
              f"; reward {hist[0]['reward']:+.4f} -> {hist[-1]['reward']:+.4f}",
              flush=True)
    result["experiment"] = exp
    return result


if __name__ == "__main__":
    main()

"""``repro_torch.perf`` — the train step's performance policies, the port
of ``repro.perf``.  Everything here is driven by
:class:`repro_torch.config.PerfConfig` (``--set perf.*`` from every front
door) and is a *runtime* choice: checkpoints move freely across policies.

* ``policy``   — PerfConfig validation, remat helpers, activation dtype
* ``fused``    — sample→rewards→advantages→update as one CUDA graph
* ``memory``   — saved-for-backward bytes and device peaks of the update
* ``offload``  — host-memory offload of the reward towers

Exactness contract (held in tests/test_torch_perf.py and
tests/test_torch_pipeline.py):

* ``remat="scan"``  : bitwise ``"none"`` — the same program, since the
  port's losses back-propagate one timestep at a time already.
* ``remat="block"`` : f32-rounding-equal (loss rtol 1e-5 / atol 1e-6, as
  the reference's band) — each block's forward runs again in the backward.
* ``fuse_step``     : on the CPU the very body of the unfused step, so
  bitwise; on the card the same kernels replayed from a graph.
* ``offload_rewards`` : bitwise the resident path — the same tensors,
  copied to and from host memory.
* ``remat_offload`` : bitwise ``"none"`` — the same program, as ``scan``.
* ``policy_dtype="bfloat16"`` on bf16 parameters: bitwise the default.
"""
from repro_torch.perf.fused import FusedStep, make_fused_step
from repro_torch.perf.memory import SavedBytes, state_bytes, update_memory
from repro_torch.perf.offload import (offload_param_store, prefetch_tree,
                                      reward_tower_report, tree_bytes,
                                      wait_tree)
from repro_torch.perf.policy import (POLICY_DTYPES, REMAT_MODES, block_remat,
                                     remat_policy, resolve_policy_dtype,
                                     validate)

__all__ = [
    "REMAT_MODES", "POLICY_DTYPES", "block_remat", "remat_policy",
    "resolve_policy_dtype", "validate", "FusedStep", "make_fused_step",
    "SavedBytes", "state_bytes", "update_memory", "offload_param_store",
    "prefetch_tree", "reward_tower_report", "tree_bytes", "wait_tree",
]

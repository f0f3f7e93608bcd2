"""``repro_torch.distributed`` — the (data, model) mesh of the port, the
port of ``repro.distributed``.

* ``mesh``       — axis resolution against the process group, the
  ``DeviceMesh`` (``train_mesh``, ``build_mesh``), ``torchrun`` set-up
* ``sharding``   — the ``PartitionPlan`` (per-leaf "model" layout, state
  sharding and gathering, byte report) and the batch checks
* ``microbatch`` — sequential gradient-accumulation chunks
* ``shard``      — data-parallel rollouts (the serving engine's keyed
  executor)

The weight gather each layer runs lives in ``repro_torch.sharding``.
``dp x mp = 1`` resolves to no mesh, the exact single-device path.
"""
from repro_torch.distributed.mesh import (DATA_AXIS, MODEL_AXIS, build_mesh,
                                          data_group, data_mesh, data_rank,
                                          init_from_env, is_main_process,
                                          mesh_dp, mesh_mp, model_group,
                                          model_rank, rank, resolve_axes,
                                          resolve_data_parallel,
                                          resolve_model_parallel, train_mesh,
                                          world_size)
from repro_torch.distributed.microbatch import (accumulated_value_and_grad,
                                                chunk_batch,
                                                chunk_trajectory)
from repro_torch.distributed.shard import (make_rollout_keyed_sharded,
                                           make_rollout_sharded,
                                           rollout_sharded)
from repro_torch.distributed.sharding import (PartitionPlan, batch_sharding,
                                              check_batch_divisible,
                                              partition_plan, replicated)

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "build_mesh", "data_group", "data_mesh",
    "data_rank", "init_from_env", "is_main_process", "mesh_dp", "mesh_mp",
    "model_group", "model_rank", "rank", "resolve_axes",
    "resolve_data_parallel", "resolve_model_parallel", "train_mesh",
    "world_size", "accumulated_value_and_grad", "chunk_batch",
    "chunk_trajectory", "make_rollout_keyed_sharded", "make_rollout_sharded",
    "rollout_sharded", "PartitionPlan", "batch_sharding",
    "check_batch_divisible", "partition_plan", "replicated",
]

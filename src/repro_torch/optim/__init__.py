"""Optimizer of the port (``repro.optim``): AdamW with f32 moments over the
parameter tree, the learning-rate schedules and global-norm clipping."""
from repro_torch import registry
from repro_torch.optim.adamw import (AdamWState, StepScalars, adamw_apply,
                                     adamw_init, adamw_update,
                                     step_scalars, write_step_scalars)
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import make_schedule


@registry.register("optimizer", "adamw")
class AdamW:
    """Registry front for the from-scratch AdamW (``init``, and ``apply``,
    the device half of a step), selected via ``OptimConfig.optimizer``."""
    init = staticmethod(adamw_init)
    apply = staticmethod(adamw_apply)


__all__ = ["AdamWState", "StepScalars", "adamw_apply", "adamw_init",
           "adamw_update", "step_scalars", "write_step_scalars",
           "make_schedule",
           "global_norm", "clip_by_global_norm", "AdamW"]

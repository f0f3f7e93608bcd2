"""Optimizer of the port (``repro.optim``): AdamW with f32 moments over the
parameter tree, the learning-rate schedules and global-norm clipping."""
from repro_torch import registry
from repro_torch.optim.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import make_schedule


@registry.register("optimizer", "adamw")
class AdamW:
    """Registry front for the from-scratch AdamW (init/update pair),
    selected via ``OptimConfig.optimizer``."""
    init = staticmethod(adamw_init)
    update = staticmethod(adamw_update)


__all__ = ["AdamWState", "adamw_init", "adamw_update", "make_schedule",
           "global_norm", "clip_by_global_norm", "AdamW"]

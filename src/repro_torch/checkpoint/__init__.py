from repro_torch.checkpoint.io import (latest_step, load_checkpoint,
                                       restore_latest, save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "restore_latest"]

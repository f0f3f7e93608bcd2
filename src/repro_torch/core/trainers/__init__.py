from repro_torch.core.trainers.base import BaseTrainer, RLState
from repro_torch.core.trainers.grpo import FlowGRPOTrainer

__all__ = ["BaseTrainer", "RLState", "FlowGRPOTrainer"]

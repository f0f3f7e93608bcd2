from repro_torch.core.trainers.base import BaseTrainer, RLState
from repro_torch.core.trainers.grpo import FlowGRPOTrainer
from repro_torch.core.trainers.mix_grpo import MixGRPOTrainer
from repro_torch.core.trainers.grpo_guard import GRPOGuardTrainer
from repro_torch.core.trainers.nft import DiffusionNFTTrainer
from repro_torch.core.trainers.awm import AWMTrainer

__all__ = ["BaseTrainer", "RLState", "FlowGRPOTrainer", "MixGRPOTrainer",
           "GRPOGuardTrainer", "DiffusionNFTTrainer", "AWMTrainer"]

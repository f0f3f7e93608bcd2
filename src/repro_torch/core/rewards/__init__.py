"""Rewards of the port (``repro.core.rewards``): the reward-model
interfaces, the concrete frozen scorers, the deduplicating multi-reward
loader and the advantage aggregators."""
from repro_torch.core.rewards import models  # noqa: F401  (registers rewards)
from repro_torch.core.rewards.aggregate import (compute_advantages,
                                                group_normalize)
from repro_torch.core.rewards.base import (BaseRewardModel,
                                           GroupwiseRewardModel,
                                           PointwiseRewardModel)
from repro_torch.core.rewards.loader import MultiRewardLoader

__all__ = ["BaseRewardModel", "PointwiseRewardModel", "GroupwiseRewardModel",
           "MultiRewardLoader", "compute_advantages", "group_normalize"]

from repro_torch.data.prompts import (PromptDataset, synthetic_dataset,
                                     synthetic_prompts)

__all__ = ["PromptDataset", "synthetic_dataset", "synthetic_prompts"]

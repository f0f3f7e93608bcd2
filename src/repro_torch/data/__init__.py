from repro_torch.data.prompts import (PromptDataset, synthetic_dataset,
                                     synthetic_prompts)
from repro_torch.data.tokens import TokenStream

__all__ = ["PromptDataset", "synthetic_dataset", "synthetic_prompts",
           "TokenStream"]

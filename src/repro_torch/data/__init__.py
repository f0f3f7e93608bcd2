from repro_torch.data.prompts import synthetic_prompts

__all__ = ["synthetic_prompts"]

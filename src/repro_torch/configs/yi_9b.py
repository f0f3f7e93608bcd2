"""yi-9b [dense] — llama-arch GQA [arXiv:2403.04652]."""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="yi-9b", family="dense",
        n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
        d_ff=11008, vocab_size=64000, head_dim=128,
        window=8192, source="arXiv:2403.04652",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="yi-9b-reduced", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        window=8192, source="arXiv:2403.04652",
    )

"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652]."""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=20480, vocab_size=64000, head_dim=128,
        window=8192, source="arXiv:2403.04652",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="yi-34b-reduced", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        window=8192, source="arXiv:2403.04652",
    )

"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
        d_ff=25600, vocab_size=151936, head_dim=128,
        qk_norm=True, window=8192, source="hf:Qwen/Qwen3-8B",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b-reduced", family="dense",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        qk_norm=True, window=8192, source="hf:Qwen/Qwen3-8B",
    )

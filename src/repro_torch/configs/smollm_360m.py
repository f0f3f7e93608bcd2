"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m", family="dense",
        n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
        d_ff=2560, vocab_size=49152, head_dim=64,
        window=8192,  # sliding-window variant engaged only at long_500k
        source="hf:HuggingFaceTB/SmolLM-135M",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="smollm-360m-reduced", family="dense",
        n_layers=2, d_model=192, n_heads=6, n_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        window=8192, source="hf:HuggingFaceTB/SmolLM-135M",
    )

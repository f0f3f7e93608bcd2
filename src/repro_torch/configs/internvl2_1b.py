"""internvl2-1b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].

Backbone-only scope (assignment carve-out): the InternViT vision encoder is a
stub frontend delivering 256 precomputed patch embeddings (1024-dim, the
InternViT-300M width) that the implemented Qwen2-style decoder consumes as a
projected prefix."""
from repro_torch.config import ArchConfig, FrontendConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab_size=151655, head_dim=64,
        window=8192,
        frontend=FrontendConfig(kind="vision", n_tokens=256, embed_dim=1024),
        source="arXiv:2404.16821",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b-reduced", family="vlm",
        n_layers=2, d_model=224, n_heads=7, n_kv_heads=1,
        d_ff=448, vocab_size=512, head_dim=32,
        window=8192,
        frontend=FrontendConfig(kind="vision", n_tokens=16, embed_dim=64),
        source="arXiv:2404.16821",
    )

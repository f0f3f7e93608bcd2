"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

Backbone-only scope (assignment carve-out): the EnCodec feature extractor /
text conditioner is a stub frontend delivering 64 conditioning frame
embeddings consumed as a projected prefix (MusicGen's cross-attention
conditioning is modelled as prefix conditioning).  The
decoder operates over the 2048-entry codebook vocabulary; the 4-codebook
delay pattern is collapsed to a single stream per the backbone-only scope."""
from repro_torch.config import ArchConfig, FrontendConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=2048, head_dim=64,
        window=8192,
        frontend=FrontendConfig(kind="audio", n_tokens=64, embed_dim=768),
        source="arXiv:2306.05284",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large-reduced", family="audio",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=512, head_dim=64,
        window=8192,
        frontend=FrontendConfig(kind="audio", n_tokens=8, embed_dim=64),
        source="arXiv:2306.05284",
    )

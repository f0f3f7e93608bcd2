"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1].

64 layers of causal GQA attention (48 query heads over 8 kv heads of 128,
the ``flash_attention`` kernel at head dim 128) and an 8-expert top-2
SwiGLU FFN of width 32768; the reduced config is CPU scale (2 layers, 4
experts)."""
from repro_torch.config import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab_size=131072, head_dim=128,
        window=8192,
        moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=32768),
        source="hf:xai-org/grok-1",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b-reduced", family="moe",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
        d_ff=512, vocab_size=512, head_dim=32,
        window=8192,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=512),
        source="hf:xai-org/grok-1",
    )

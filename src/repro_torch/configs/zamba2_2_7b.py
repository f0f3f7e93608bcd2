"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242].

54 Mamba2 layers with a single *shared* attention+MLP block (one parameter
set, reused) applied every 6 layers — 9 application sites.  ssm_state=64.
The shared attention is causal GQA with 32 heads of 80 (the
``flash_attention`` kernel at head dim 80); the reduced config is CPU
scale (2 groups of 1 SSM block, heads of 64)."""
from repro_torch.config import ArchConfig, HybridConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab_size=32000, head_dim=80,
        window=8192,
        ssm=SSMConfig(d_state=64, expand=2, head_dim=64, chunk=128, d_conv=4),
        hybrid=HybridConfig(attn_every=6, shared_attn=True),
        source="arXiv:2411.15242",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="zamba2-2.7b-reduced", family="hybrid",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=512, vocab_size=512, head_dim=64,
        window=8192,
        ssm=SSMConfig(d_state=32, expand=2, head_dim=32, chunk=32, d_conv=4),
        hybrid=HybridConfig(attn_every=1, shared_attn=True),
        source="arXiv:2411.15242",
    )

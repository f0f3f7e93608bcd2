"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434].

d_ff=1536 is the routed-expert width; the first layer is dense with the
model-card dense width 12288.  n_kv_heads=128 reflects MLA (every head reads
the shared rank-512 latent; there is no classic KV grouping).  The
train/prefill attention runs the ``flash_attention`` kernels at a query/key
dim of 192 (128 + 64 rope) and a value dim of 128.
"""
from repro_torch.config import ArchConfig, MLAConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b", family="moe",
        n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
        d_ff=12288,                 # dense width of the first_k_dense layer
        vocab_size=102400,
        window=8192,
        moe=MoEConfig(n_experts=160, top_k=6, n_shared_experts=2,
                      expert_d_ff=1536, first_k_dense=1),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        source="arXiv:2405.04434",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-236b-reduced", family="moe",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
        d_ff=512, vocab_size=512,
        window=8192,
        moe=MoEConfig(n_experts=4, top_k=2, n_shared_experts=1,
                      expert_d_ff=128, first_k_dense=1),
        mla=MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                      qk_nope_head_dim=32, qk_rope_head_dim=16,
                      v_head_dim=32),
        source="arXiv:2405.04434",
    )

"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: n_heads/n_kv_heads/d_ff are 0; sequence mixing is the
chunked SSD scan (the ``ssd_scan`` kernel).  The full config is the
published width (d_model 1024, 48 layers, d_inner 2048, 32 SSD heads of 64,
d_state 128, chunk 128, conv width 4); the reduced one is CPU scale."""
from repro_torch.config import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk=128,
                      d_conv=4),
        source="arXiv:2405.21060",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m-reduced", family="ssm",
        n_layers=2, d_model=256, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=512,
        ssm=SSMConfig(d_state=32, expand=2, head_dim=32, chunk=32, d_conv=4),
        source="arXiv:2405.21060",
    )

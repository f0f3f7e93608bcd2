"""flux_dit [dit] — the paper's own model family: a FLUX.1-style rectified-flow
DiT (Black Forest Labs).

Bidirectional attention over [condition; latent] tokens with adaLN-zero
time modulation.  The full config is FLUX.1-dev-like geometry (38 blocks,
d_model 3072, 24 heads of 128, ≈8.1 B parameters with this repo's block);
the reduced one is the ~100M-class CPU-scale model of the examples.  vocab_size
is unused on the flow path (continuous latents)."""
from repro_torch.config import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="flux_dit", family="dit",
        n_layers=38, d_model=3072, n_heads=24, n_kv_heads=24,
        d_ff=12288, vocab_size=32768, head_dim=128,
        qk_norm=True, window=0,
        source="bfl.ai FLUX.1-dev (paper §4)",
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="flux_dit-reduced", family="dit",
        n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
        d_ff=1024, vocab_size=512, head_dim=32,
        qk_norm=True, window=0,
        source="bfl.ai FLUX.1-dev (paper §4)",
    )

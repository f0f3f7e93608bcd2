"""Stub modality frontends (``repro.models.frontends``).

The ``vlm`` and ``audio`` architectures specify the transformer backbone
only; the modality frontend (the InternViT vision encoder, the EnCodec
feature extractor) is a stub: ``embeddings()`` delivers patch/frame
embeddings of the right shape, which the backbone projects through its
``frontend_proj`` leaf into a prefix of the token sequence.  The decoder
that consumes them is fully implemented.

JAX's threefry and torch's Philox draws never match, so ``embeddings``
draws from an explicit ``torch.Generator`` (f32 normals cast to bf16, as
the reference casts its draw) or takes the embeddings as an injected
array, which is how the parity tests feed both packages the same numbers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import registry
from repro_torch.config import FrontendConfig


@registry.register("frontend", "none")
class NoFrontend:
    def __init__(self, cfg: FrontendConfig):
        self.cfg = cfg

    def embeddings(self, generator: Optional[torch.Generator], batch: int,
                   *, injected=None, device=None) -> None:
        return None


class _StubFrontend:
    """Embedding generator standing in for a frozen encoder; the real
    pipeline would run InternViT / EnCodec here and the preprocessing
    cache would store its outputs."""

    def __init__(self, cfg: FrontendConfig):
        if not (cfg.n_tokens > 0 and cfg.embed_dim > 0):
            raise ValueError(f"a {cfg.kind!r} frontend needs n_tokens > 0 "
                             f"and embed_dim > 0, got {cfg}")
        self.cfg = cfg

    def embeddings(self, generator: Optional[torch.Generator], batch: int,
                   *, injected=None, device=None) -> torch.Tensor:
        """(batch, n_tokens, embed_dim) bf16: f32 normals from
        ``generator`` (on its device unless ``device`` is given), or
        ``injected`` (an array of that shape) cast to bf16."""
        shape = (batch, self.cfg.n_tokens, self.cfg.embed_dim)
        if injected is not None:
            t = torch.as_tensor(np.asarray(injected, np.float32),
                                device=device)
            if tuple(t.shape) != shape:
                raise ValueError(f"injected embeddings of shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            return t.to(torch.bfloat16)
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device or generator.device
                           ).to(torch.bfloat16)


@registry.register("frontend", "vision")
class VisionFrontendStub(_StubFrontend):
    """InternViT patch embeddings (InternVL2, arXiv:2404.16821)."""


@registry.register("frontend", "audio")
class AudioFrontendStub(_StubFrontend):
    """EnCodec conditioning frames (MusicGen, arXiv:2306.05284)."""


def build(cfg: FrontendConfig):
    return registry.build("frontend", cfg.kind, cfg)

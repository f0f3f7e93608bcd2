"""Condition encoding of the port — the live path of
``repro.core.preprocess``.

``FrozenTextEncoder`` is the reference's text-tower stand-in: prompts are
tokenised by word hashing (the same ids as the reference), embedded through
a frozen table and run through frozen ``tanh`` projections.  Its weights are
drawn from a ``torch.Generator`` seeded with ``seed``, or carried over from
the JAX package's encoder with ``weights=`` (numpy arrays, as
``models.params.from_numpy`` takes them).  ``ConditionProvider`` serves the
live path (every request re-encoded); the preprocessing cache on disk comes
with the training slice.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import from_numpy

F32 = torch.float32


class FrozenTextEncoder:
    """Frozen condition encoder (text-tower stand-in), on ``device``.

    ``weights``: optional ``{"embed": (vocab, hidden), "layers": {"0": (hidden,
    hidden), ...}, "w_out": (hidden, cond_dim)}`` of numpy arrays (the JAX
    encoder's ``embed``, ``layers`` and ``w_out``) to use instead of a fresh
    draw."""

    def __init__(self, cond_dim: int = 512, cond_len: int = 16,
                 vocab: int = 32768, hidden: int = 2048, depth: int = 2,
                 seed: int = 3, *, device=None,
                 weights: Optional[Dict] = None):
        self.cond_dim, self.cond_len = cond_dim, cond_len
        self.vocab, self.hidden, self.depth = vocab, hidden, depth
        self.device = resolve_device(device)
        if weights is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)

            def draw(shape, scale):
                return torch.randn(shape, generator=gen, dtype=F32,
                                   device=self.device).mul_(scale)

            self.embed = draw((vocab, hidden), 0.02)
            self.layers = [draw((hidden, hidden), 1.0 / math.sqrt(hidden))
                           for _ in range(depth)]
            self.w_out = draw((hidden, cond_dim), 1.0 / math.sqrt(hidden))
        else:
            w = from_numpy(weights, self.device, F32)
            self.embed, self.w_out = w["embed"], w["w_out"]
            self.layers = [w["layers"][k]
                           for k in sorted(w["layers"], key=int)]
            if (tuple(self.embed.shape) != (vocab, hidden)
                    or tuple(self.w_out.shape) != (hidden, cond_dim)
                    or len(self.layers) != depth):
                raise ValueError("encoder weights do not fit "
                                 f"vocab={vocab} hidden={hidden} "
                                 f"depth={depth} cond_dim={cond_dim}")

    def tokenize(self, prompt: str) -> np.ndarray:
        words = (prompt.lower().split() + ["<pad>"] * self.cond_len)
        ids = [int(hashlib.sha1(w.encode()).hexdigest()[:8], 16) % self.vocab
               for w in words[:self.cond_len]]
        return np.asarray(ids, np.int64)

    @torch.no_grad()
    def encode(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        """{"cond": (N, cond_len, cond_dim), "pooled": (N, cond_dim)}, f32 on
        the encoder's device."""
        ids = torch.from_numpy(np.stack([self.tokenize(p) for p in prompts]))
        h = self.embed[ids.to(self.device)]               # (N, L, hidden)
        for w in self.layers:
            h = torch.tanh(h @ w)
        emb = h @ self.w_out                               # (N, L, cond_dim)
        return {"cond": emb, "pooled": emb.mean(dim=1)}


class ConditionProvider:
    """Condition source of the serving path: ``preprocessing=False``
    re-encodes every request through a resident ``FrozenTextEncoder``
    (built on first use).  The cache-backed ``preprocessing=True`` mode
    comes with the training slice."""

    def __init__(self, *, preprocessing: bool = False,
                 encoder_kw: Optional[dict] = None, device=None):
        if preprocessing:
            raise NotImplementedError(
                "the preprocessing cache is not ported yet (ROADMAP.md "
                "Queue 1, training slice): use preprocessing=False")
        self.device = resolve_device(device)
        self._encoder: Optional[FrozenTextEncoder] = None
        self._encoder_kw = dict(encoder_kw or {})

    def _ensure_encoder(self) -> FrozenTextEncoder:
        if self._encoder is None:
            self._encoder = FrozenTextEncoder(**self._encoder_kw,
                                              device=self.device)
        return self._encoder

    def get(self, prompts: Sequence[str]) -> Dict[str, torch.Tensor]:
        return self._ensure_encoder().encode(prompts)

"""Token stream for the LM-role training path (``repro.data.tokens``): a
synthetic corpus with learnable structure — a hash-ngram Markov source, so
CE decreases and tests can assert learning, unlike uniform-random tokens.
numpy only; the same seed gives the reference's batches bit for bit."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, batch: int, seq: int, *,
                 seed: int = 0, order: int = 2):
        self.vocab, self.batch, self.seq = vocab_size, batch, seq
        self.order = order
        self.rng = np.random.RandomState(seed)
        # deterministic sparse transition structure
        self._mix = self.rng.randint(1, vocab_size, size=(order,))

    def _next_token(self, ctx: np.ndarray, noise: np.ndarray) -> np.ndarray:
        det = (ctx * self._mix[None]).sum(-1) % self.vocab
        return np.where(noise < 0.8, det, self.rng.randint(
            0, self.vocab, size=det.shape))

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            toks = np.zeros((self.batch, self.seq + 1), np.int32)
            toks[:, :self.order] = self.rng.randint(
                0, self.vocab, size=(self.batch, self.order))
            for i in range(self.order, self.seq + 1):
                noise = self.rng.rand(self.batch)
                toks[:, i] = self._next_token(
                    toks[:, i - self.order:i], noise)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

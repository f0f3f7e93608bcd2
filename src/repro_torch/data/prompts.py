"""Prompt dataset of the port — a copy of ``repro.data.prompts``.

``synthetic_prompts`` generates the same deterministic compositional prompt
corpus as the reference (numpy's ``RandomState``, so the two packages give
the same prompts for the same ``(n, seed)``); ``PromptDataset`` gives the
same shuffled epoch batches, with per-host sharding.  The corpus is
registered as ``dataset:synthetic``.
"""
from __future__ import annotations

import itertools
from typing import Iterator, List, Sequence

import numpy as np

from repro_torch import registry

_SUBJECTS = ["a fox", "an astronaut", "a teapot", "two dancers", "a robot",
             "a lighthouse", "an origami crane", "a neon sign", "a tram",
             "a violin"]
_STYLES = ["in watercolor", "as pixel art", "in film noir lighting",
           "as a blueprint", "in ukiyo-e style", "as claymation",
           "in double exposure", "as stained glass"]
_TEXTS = ["with the word 'flow' painted on it", "holding a sign saying 'RL'",
          "next to graffiti reading 'factory'", "at golden hour",
          "under a thunderstorm", ""]


def synthetic_prompts(n: int, seed: int = 0) -> List[str]:
    """``n`` prompts of the compositional corpus, in a seeded order."""
    rng = np.random.RandomState(seed)
    combos = list(itertools.product(_SUBJECTS, _STYLES, _TEXTS))
    idx = rng.permutation(len(combos))
    out = []
    for i in range(n):
        s, st, tx = combos[idx[i % len(combos)]]
        out.append(" ".join(w for w in (s, st, tx) if w))
    return out


class PromptDataset:
    def __init__(self, prompts: Sequence[str], batch_size: int, *,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1):
        self.prompts = list(prompts)[host_id::n_hosts]
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self) -> int:
        return len(self.prompts)

    @property
    def batches_per_epoch(self) -> int:
        n = len(self.prompts)
        if n < self.batch_size:
            return 0
        return (n - self.batch_size) // self.batch_size + 1

    def epoch(self, epoch_idx: int, start_batch: int = 0
              ) -> Iterator[List[str]]:
        rng = np.random.RandomState(self.seed + epoch_idx)
        order = rng.permutation(len(self.prompts))
        for i in range(start_batch * self.batch_size,
                       len(order) - self.batch_size + 1, self.batch_size):
            yield [self.prompts[j] for j in order[i:i + self.batch_size]]

    def infinite(self, skip: int = 0) -> Iterator[List[str]]:
        """Endless shuffled batches; ``skip`` fast-forwards past the first
        ``skip`` batches in O(1) (each epoch's permutation is a function of
        ``seed + epoch_idx`` alone, which resume relies on)."""
        if skip < 0:
            raise ValueError(f"skip must be >= 0, got {skip}")
        per = self.batches_per_epoch
        if per == 0:
            raise ValueError(
                f"dataset of {len(self.prompts)} prompts yields no batch of "
                f"size {self.batch_size} — nothing to iterate")
        e0, off = divmod(skip, per)
        for e in itertools.count(e0):
            yield from self.epoch(e, start_batch=off if e == e0 else 0)


@registry.register("dataset", "synthetic")
def synthetic_dataset(n_prompts: int = 64, batch_prompts: int = 4,
                      seed: int = 0, host_id: int = 0,
                      n_hosts: int = 1) -> PromptDataset:
    """Deterministic compositional prompt corpus wrapped in a PromptDataset
    (the config-addressable default training distribution)."""
    return PromptDataset(synthetic_prompts(n_prompts, seed=seed),
                         batch_size=batch_prompts, seed=seed,
                         host_id=host_id, n_hosts=n_hosts)

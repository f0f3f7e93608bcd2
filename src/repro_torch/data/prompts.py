"""Prompt corpus of the port — a copy of ``repro.data.prompts``.

``synthetic_prompts`` generates the same deterministic compositional prompt
corpus as the reference (numpy's ``RandomState``, so the two packages give
the same prompts for the same ``(n, seed)``).  ``PromptDataset`` and the
``dataset:synthetic`` registration come with the training slice.
"""
from __future__ import annotations

import itertools
from typing import List

import numpy as np

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

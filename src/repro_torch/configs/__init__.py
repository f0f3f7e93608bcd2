"""Architecture configs of the port, registered under the ``"arch"`` kind.

Each module exports ``config()`` (the full-scale config) and ``reduced()``
(≤2 layers, CPU smoke scale).  ``ARCH_IDS`` are the reference's ten
assigned archs in its order (every family: dense, MoE, SSM, hybrid and the
frontend families ``vlm`` and ``audio``), ``PAPER_ARCHS`` the paper's own
DiT, so the ``"arch"`` kind holds the reference's eleven names.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch import registry
from repro_torch.config import ArchConfig

ARCH_IDS = ["zamba2-2.7b", "grok-1-314b", "yi-34b", "internvl2-1b",
            "deepseek-v2-236b", "smollm-360m", "qwen3-32b", "yi-9b",
            "mamba2-370m", "musicgen-large"]

PAPER_ARCHS = ["flux_dit"]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in
        ARCH_IDS + PAPER_ARCHS}


def _load(arch: str):
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MOD)}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")


def get(arch: str) -> ArchConfig:
    return _load(arch).config()


def get_reduced(arch: str) -> ArchConfig:
    return _load(arch).reduced()


def all_archs() -> List[str]:
    return list(ARCH_IDS)


def _arch_factory(arch: str):
    def build(reduced: bool = False) -> ArchConfig:
        return get_reduced(arch) if reduced else get(arch)
    build.__doc__ = (f"ArchConfig for {arch} "
                     "(reduced=True -> CPU-scale smoke variant).")
    build.__name__ = f"arch_{_MOD[arch]}"
    return build


for _a in ARCH_IDS + PAPER_ARCHS:
    if not registry.is_registered("arch", _a):
        registry.register("arch", _a)(_arch_factory(_a))
del _a

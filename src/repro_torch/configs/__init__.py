"""Architecture configs of the port, registered under the ``"arch"`` kind.

Each module exports ``config()`` (the full-scale config) and ``reduced()``
(≤2 layers, CPU smoke scale).  Only the paper's own DiT family is ported so
far; the other archs of ``repro.configs`` come with their families.
"""
from __future__ import annotations

import importlib

from repro_torch import registry
from repro_torch.config import ArchConfig

PAPER_ARCHS = ["flux_dit"]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in PAPER_ARCHS}


def _load(arch: str):
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MOD)}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")


def get(arch: str) -> ArchConfig:
    return _load(arch).config()


def get_reduced(arch: str) -> ArchConfig:
    return _load(arch).reduced()


def _arch_factory(arch: str):
    def build(reduced: bool = False) -> ArchConfig:
        return get_reduced(arch) if reduced else get(arch)
    build.__doc__ = (f"ArchConfig for {arch} "
                     "(reduced=True -> CPU-scale smoke variant).")
    build.__name__ = f"arch_{_MOD[arch]}"
    return build


for _a in PAPER_ARCHS:
    if not registry.is_registered("arch", _a):
        registry.register("arch", _a)(_arch_factory(_a))
del _a

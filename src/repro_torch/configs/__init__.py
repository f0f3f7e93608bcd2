"""Architecture configs of the port, registered under the ``"arch"`` kind.

Each module exports ``config()`` (the full-scale config) and ``reduced()``
(≤2 layers, CPU smoke scale).  The paper's own DiT family, the dense LM
family, the MoE family (grok-1 and DeepSeek-V2 with its latent attention),
the Mamba-2 SSM and the Zamba2 hybrid are ported so far; the frontend archs
of ``repro.configs`` (``internvl2-1b``, ``musicgen-large``) come with their
families.
"""
from __future__ import annotations

import importlib

from repro_torch import registry
from repro_torch.config import ArchConfig

# the reference's assigned archs whose family the port runs so far
ARCH_IDS = ["zamba2-2.7b", "grok-1-314b", "yi-34b", "deepseek-v2-236b",
            "smollm-360m", "qwen3-32b", "yi-9b", "mamba2-370m"]

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

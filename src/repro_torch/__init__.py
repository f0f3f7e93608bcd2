"""repro_torch — the PyTorch/CUDA port of ``repro`` (Flow-Factory), for one
NVIDIA H100.

It mirrors the reference package module for module
(``repro/core/rollout.py`` → ``repro_torch/core/rollout.py``) and imports
neither ``jax`` nor anything of ``repro``.  Every TPU kernel on the ported
path is a hand-written CUDA kernel under ``repro_torch/kernels/csrc``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
__version__ = "0.1.0"

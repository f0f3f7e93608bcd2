"""MultiRewardLoader — multi-reward training with automatic deduplication
(paper §2.3) — the port of ``repro.core.rewards.loader``.

Several :class:`RewardSpec` entries may reference the same frozen backbone
(``model_id``); the loader builds each unique backbone once, on ``device``,
and shares its parameters across every reward that references it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from repro_torch import registry
from repro_torch.config import RewardSpec
from repro_torch.core.rewards.base import BaseRewardModel


class MultiRewardLoader:
    def __init__(self, specs: Sequence[RewardSpec], seed: int = 0,
                 device="cpu"):
        self.specs = tuple(specs)
        self.models: List[BaseRewardModel] = []
        self.weights: List[float] = []
        self._param_store: Dict[str, object] = {}
        self.unique_loads = 0
        for i, spec in enumerate(self.specs):
            kwargs = dict(spec.args)
            if spec.model_id:
                kwargs["model_id"] = spec.model_id
            model: BaseRewardModel = registry.build(
                "reward", spec.reward_type, **kwargs)
            if model.model_id not in self._param_store:
                gen = torch.Generator(device=device).manual_seed(seed + i)
                self._param_store[model.model_id] = model.load_params(gen)
                self.unique_loads += 1
            model.set_params(self._param_store[model.model_id])
            self.models.append(model)
            self.weights.append(spec.weight)

    def __len__(self) -> int:
        return len(self.models)

    def param_store(self) -> Dict[str, object]:
        """The deduplicated {model_id: params} store."""
        return dict(self._param_store)

    def bind(self, store: Dict[str, object]) -> None:
        """Replace the store (keyed by model_id) and point every model at
        it: how ``perf.offload_rewards`` moves the towers to host memory
        (the reference's ``rebase``), and how the tests carry the
        reference's towers across."""
        if set(store) != set(self._param_store):
            raise ValueError(
                f"store keys {sorted(store)} != loaded model ids "
                f"{sorted(self._param_store)}")
        self._param_store = dict(store)
        self._point(self._param_store)

    def _point(self, store: Dict[str, object]) -> None:
        for model in self.models:
            model.set_params(store[model.model_id])

    @torch.no_grad()
    def has_kind(self, kind: str) -> bool:
        """Whether any configured reward model is ``kind`` ("pointwise" or
        "groupwise")."""
        return any(m.kind == kind for m in self.models)

    def compute_all(self, x0: torch.Tensor, cond_meta: Dict, *,
                    group_size: int, params: Dict[str, object] = None,
                    kinds=("pointwise", "groupwise")
                    ) -> Dict[str, torch.Tensor]:
        """{reward_name: (B,) raw rewards} for every configured reward of
        one of ``kinds`` (groupwise models are evaluated within GRPO
        groups).  ``params`` replaces the store for this evaluation (the
        device copy of host-offloaded towers); the models point at the
        store again afterwards."""
        if params is not None:
            self._point(params)
        try:
            out = {}
            for i, (spec, model) in enumerate(zip(self.specs, self.models)):
                if model.kind not in kinds:
                    continue
                name = f"{spec.reward_type}:{i}"
                if model.kind == "groupwise":
                    out[name] = model.score(x0, cond_meta,
                                            group_size=group_size)
                else:
                    out[name] = model.score(x0, cond_meta)
            return out
        finally:
            if params is not None:
                # torchlint: disable=R003 — bind runs once, from
                # offload_param_store at trainer construction, before any
                # capture; this re-points the models and launches nothing
                self._point(self._param_store)

    def weight_map(self) -> Dict[str, float]:
        return {f"{s.reward_type}:{i}": s.weight
                for i, s in enumerate(self.specs)}

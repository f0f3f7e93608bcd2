"""``repro_torch.api`` — the port's config-first front door (serve half):
:class:`Experiment`, :class:`FlowSampler` and the dotted ``--set``
overrides."""
from repro_torch.api.experiment import Experiment, default_cli_config
from repro_torch.api.overrides import apply_overrides, parse_assignments
from repro_torch.api.serving import FlowSampler
from repro_torch.serving import ServingEngine

__all__ = ["Experiment", "default_cli_config", "apply_overrides",
           "parse_assignments", "FlowSampler", "ServingEngine"]

"""``repro_torch.api`` — the port's config-first front door:
:class:`Experiment` (``train()`` through the shared :class:`TrainLoop` with
full-state checkpoint/resume, and ``serve()``), the :class:`Callback`
protocol (``MetricLogger``, ``JSONLogSink``, ``PeriodicCheckpoint``,
``EarlyStop``), :class:`FlowSampler` and the dotted ``--set`` overrides."""
from repro_torch.api.experiment import Experiment, default_cli_config
from repro_torch.api.loop import (Callback, EarlyStop, JSONLogSink,
                                  MetricLogger, PeriodicCheckpoint, TrainLoop)
from repro_torch.api.overrides import apply_overrides, parse_assignments
from repro_torch.api.serving import FlowSampler
from repro_torch.serving import ServingEngine

__all__ = ["Experiment", "default_cli_config", "TrainLoop", "Callback",
           "MetricLogger", "JSONLogSink", "PeriodicCheckpoint", "EarlyStop",
           "apply_overrides", "parse_assignments", "FlowSampler",
           "ServingEngine"]

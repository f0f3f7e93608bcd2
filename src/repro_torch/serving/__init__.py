"""``repro_torch.serving`` — the port's inference subsystem: a request-queue
engine with bucketed continuous batching, priority classes with
weighted-fair dequeue, SLO deadlines, admission control with structured
retry-after backpressure, warmup and an LRU cond-encoding cache, sharded
over a (data, model) mesh.  ``FlowSampler`` (``repro_torch.api.serving``)
and ``repro_torch.launch.serve`` are thin clients; trainers opt in via
``BaseTrainer.attach_engine``."""
from repro_torch.serving.admission import (DEFAULT_CLASSES, AdmissionConfig,
                                           AdmissionController, PriorityClass,
                                           RetryAfter)
from repro_torch.serving.buckets import BucketGrid, StepGrid, default_buckets
from repro_torch.serving.engine import CondCache, Request, ServingEngine

__all__ = ["AdmissionConfig", "AdmissionController", "BucketGrid",
           "CondCache", "DEFAULT_CLASSES", "PriorityClass", "Request",
           "RetryAfter", "ServingEngine", "StepGrid", "default_buckets"]

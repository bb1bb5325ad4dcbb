"""Observability of the port: the metrics registry and its recorders.

Only ``repro.obs.metrics`` is ported so far; the tracer, audit trail,
ledger and profiler of ``repro.obs`` are not (ROADMAP Queue A item 6).
"""
from repro_torch.obs.metrics import (HeatmapRecorder, MetricsRegistry,
                                     PredictionTracker, percentile,
                                     summarize)

__all__ = ["percentile", "summarize", "MetricsRegistry", "HeatmapRecorder",
           "PredictionTracker"]

"""Observability of the port: the metrics registry and its recorders, and
the span tracer.

``repro.obs.metrics`` and ``repro.obs.trace`` are ported; the audit trail,
ledger and profiler of ``repro.obs`` are not (ROADMAP Queue A item 6).
"""
from repro_torch.obs.metrics import (HeatmapRecorder, MetricsRegistry,
                                     PredictionTracker, percentile,
                                     summarize)
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["percentile", "summarize", "MetricsRegistry", "HeatmapRecorder",
           "PredictionTracker", "Tracer", "NULL_TRACER"]

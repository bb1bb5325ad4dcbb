"""Observability of the port: the metrics registry and its recorders, the
span tracer, the replan-decision audit log, and the hot-loop FLOP/byte
ledger and profiler (counterparts of ``repro.obs``'s modules of the same
names)."""
from repro_torch.obs.audit import ReplanAudit
from repro_torch.obs.ledger import PHASES, FlopByteLedger, IterLedger
from repro_torch.obs.metrics import (HeatmapRecorder, MetricsRegistry,
                                     PredictionTracker, percentile,
                                     summarize)
from repro_torch.obs.profiler import (MOE_STAGES, NULL_PROFILER,
                                      NullProfiler, Profiler,
                                      time_moe_phases)
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["percentile", "summarize", "MetricsRegistry", "HeatmapRecorder",
           "PredictionTracker", "Tracer", "NULL_TRACER", "ReplanAudit",
           "PHASES", "FlopByteLedger", "IterLedger", "MOE_STAGES",
           "NULL_PROFILER", "NullProfiler", "Profiler", "time_moe_phases"]

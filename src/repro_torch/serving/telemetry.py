"""Serving telemetry: rolling-window aggregation of engine iterations and
request latencies into SLO-style percentiles.

The engine emits one :class:`~repro_torch.serving.engine.IterStats` per forward
batch — prefill chunks included, which is where ReaLB's LB gate opens —
and one finished :class:`~repro_torch.serving.scheduler.Request` per completion.
The collector keeps bounded deques (``window`` iterations / requests) so a
long-running server reports *recent* percentiles, and exposes the headline
quantities of the paper's serving evaluation: TTFT / TPOT percentiles,
``ib_global`` distribution, and LB-gate / FP4 duty cycles split by phase.

Cumulative quantities (migration bytes/seconds, plan commits, elastic
availability, recoveries) live on a typed
:class:`~repro_torch.obs.metrics.MetricsRegistry` — the seed's ad-hoc instance
attributes survive as property shims so existing readers keep working —
and two :mod:`repro_torch.obs.metrics` recorders ride along: the per-layer
per-rank expert-load heatmap and the predicted-vs-realized peak-rank-load
accuracy tracker (opened per committed replan window).

Percentiles use the linear-interpolation definition (numpy's default);
the math lives in :mod:`repro_torch.obs.metrics` and is re-exported here.

The port's copy of ``repro.serving.telemetry``: the same summaries from
the same feeds.  The placement, migration and elastic fields of
``IterStats`` stay 0 until those subsystems are ported, and no profiler
shares the registry, so ``_profiler_summary`` gives ``{}``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

from repro_torch.obs.metrics import (HeatmapRecorder, MetricsRegistry,
                                     PredictionTracker, percentile, summarize)

__all__ = ["percentile", "summarize", "RequestLatency", "Telemetry"]


@dataclasses.dataclass
class RequestLatency:
    uid: int
    ttft: float                  # arrival -> first token
    tpot: Optional[float]        # per-token after the first (None if 1 tok)
    prompt_len: int
    n_generated: int
    is_vision: bool


class Telemetry:
    """Rolling-window collector; feed it from the engine, read summaries."""

    def __init__(self, window: int = 512,
                 registry: Optional[MetricsRegistry] = None):
        self.window = window
        self.iters: Deque = deque(maxlen=window)        # IterStats
        self.requests: Deque[RequestLatency] = deque(maxlen=window)
        self.n_iters = 0
        self.n_requests = 0
        self.registry = registry if registry is not None else MetricsRegistry()
        reg = self.registry
        # migration accounting is cumulative (not windowed): the question
        # the paper's comparison asks is "how many bytes did placement move
        # over the whole run, vs. ReaLB's zero".  Bytes stay integral
        # end-to-end (plans count whole weight bytes, never fractions);
        # seconds are split into serving *stall* (migration_s_total) and
        # transfer time *hidden* under the forward by async overlap.
        self._mig_bytes = reg.counter(
            "migration_bytes", "weight bytes moved by replans")
        self._mig_s = reg.counter(
            "migration_stall_s", "serving seconds stalled on migration")
        self._mig_hidden_s = reg.counter(
            "migration_hidden_s",
            "migration transfer seconds hidden under the forward")
        # one count per iteration that carried migration traffic — under
        # async draining that is one per chunk batch, not per plan; plan
        # commits are counted separately (record_plan_commit)
        self._mig_iters = reg.counter(
            "migration_iters", "iterations carrying migration traffic")
        self._plan_commits = reg.counter(
            "plans_committed", "replan plans fully committed")
        # elastic-serving availability accounting (cumulative, like the
        # migration counters): an iteration is *degraded* when >= 1
        # expert was unroutable (a rank died and took the only replica);
        # each completed recovery stamps its wall seconds
        self._degraded = reg.counter(
            "degraded_iters", "iterations with >=1 unroutable expert")
        self._lost_tokens = reg.counter(
            "lost_tokens", "expected tokens lost to unroutable experts")
        self._recovery_hist = reg.histogram(
            "recovery_s", "seconds from rank loss to full routability")
        self.heatmap = HeatmapRecorder()
        self.prediction = PredictionTracker()

    # -- seed-compat shims: cumulative attrs now live on the registry -----
    @property
    def migration_bytes_total(self) -> int:
        return int(self._mig_bytes.value())

    @property
    def migration_s_total(self) -> float:
        return float(self._mig_s.value())

    @property
    def migration_hidden_s_total(self) -> float:
        return float(self._mig_hidden_s.value())

    @property
    def n_migrations(self) -> int:
        return int(self._mig_iters.value())

    @property
    def n_plans_committed(self) -> int:
        return int(self._plan_commits.value())

    @property
    def degraded_iters(self) -> int:
        return int(self._degraded.value())

    @property
    def lost_tokens_total(self) -> float:
        return float(self._lost_tokens.value())

    @property
    def recoveries(self) -> List[float]:
        return self._recovery_hist.values()

    # -- feeds ------------------------------------------------------------
    def record_iter(self, stat) -> None:
        self.iters.append(stat)
        self.n_iters += 1
        if getattr(stat, "n_unroutable", 0) > 0:
            self._degraded.inc()
            self._lost_tokens.inc(float(getattr(stat, "lost_tokens", 0.0)))
        mig = getattr(stat, "migration_bytes", 0)
        mig_s = getattr(stat, "migration_s", 0.0)
        mig_h = getattr(stat, "migration_hidden_s", 0.0)
        # zero-byte migration work still carries real seconds (e.g. a
        # drained replica batch of same-rank copies priced at 0 bytes
        # under a wall clock) — never drop measured time on the floor
        if mig > 0 or mig_s > 0 or mig_h > 0:
            self._mig_bytes.inc(int(mig))
            self._mig_s.inc(mig_s)
            self._mig_hidden_s.inc(mig_h)
            self._mig_iters.inc()

    def record_plan_commit(self) -> None:
        """One replan plan fully committed (sync apply, or the last
        layer of an async drain landing)."""
        self._plan_commits.inc()

    def record_rank_heatmap(self, heatmap) -> None:
        """Per-iteration ``[L, R]`` rank loads from the live tables;
        feeds the expert-load heatmap and the open prediction window."""
        if heatmap is None:
            return
        self.heatmap.record(heatmap)
        self.prediction.record(heatmap)

    def open_prediction_window(self, it: int, predicted) -> None:
        """Stamp the predictor's per-layer rank loads at a plan commit;
        closes the previous window (see PredictionTracker)."""
        self.prediction.open(it, predicted)

    def record_recovery(self, seconds: float) -> None:
        """One completed elastic recovery (rank loss -> every expert
        routable again), in wall/virtual seconds."""
        self._recovery_hist.observe(float(seconds))

    def record_request(self, req) -> None:
        if req.ttft is None:
            return
        self.requests.append(RequestLatency(
            uid=req.uid, ttft=req.ttft, tpot=req.tpot,
            prompt_len=req.prompt_len, n_generated=len(req.generated),
            is_vision=req.is_vision))
        self.n_requests += 1

    # -- summaries --------------------------------------------------------
    def _phase(self, phase: Optional[str]) -> List:
        return [s for s in self.iters
                if phase is None or s.phase == phase]

    def gate_duty(self, phase: Optional[str] = "prefill") -> float:
        """Fraction of (phase-filtered) iterations with the LB gate open."""
        it = self._phase(phase)
        if not it:
            return 0.0
        return sum(1.0 for s in it if s.gate_open > 0) / len(it)

    def fp4_duty(self, phase: Optional[str] = None) -> float:
        """Fraction of iterations on which >=1 rank ran its experts in FP4."""
        it = self._phase(phase)
        if not it:
            return 0.0
        return sum(1.0 for s in it if s.fp4_ranks > 0) / len(it)

    def split_duty(self, phase: Optional[str] = None) -> float:
        """Fraction of iterations on which a non-primary replica served
        routed tokens (always 0 under a bijective table)."""
        it = self._phase(phase)
        if not it:
            return 0.0
        return sum(1.0 for s in it
                   if getattr(s, "split_frac", 0.0) > 0) / len(it)

    def split_summary(self, phase: Optional[str] = None) -> Dict[str, float]:
        """Rolling-window token-split fraction percentiles."""
        return summarize([getattr(s, "split_frac", 0.0)
                          for s in self._phase(phase)])

    def ib_summary(self, phase: Optional[str] = None) -> Dict[str, float]:
        return summarize([s.ib_global for s in self._phase(phase)])

    def drop_summary(self, phase: Optional[str] = None) -> Dict[str, float]:
        """Rolling-window capacity-drop fraction percentiles."""
        return summarize([getattr(s, "drop_frac", 0.0)
                          for s in self._phase(phase)])

    @property
    def availability(self) -> float:
        """Fraction of iterations with every expert routable (1.0 when
        no iteration ever ran degraded)."""
        if self.n_iters == 0:
            return 1.0
        return 1.0 - self.degraded_iters / self.n_iters

    def ttft_summary(self) -> Dict[str, float]:
        return summarize([r.ttft for r in self.requests])

    def tpot_summary(self) -> Dict[str, float]:
        return summarize([r.tpot for r in self.requests
                          if r.tpot is not None])

    def summary(self) -> Dict[str, object]:
        """One flat report dict (benchmark / log-line friendly)."""
        by_mod = {
            "vision": [r.ttft for r in self.requests if r.is_vision],
            "text": [r.ttft for r in self.requests if not r.is_vision],
        }
        recoveries = self.recoveries
        return {
            "n_iters": self.n_iters,
            "n_requests": self.n_requests,
            "ttft": self.ttft_summary(),
            "ttft_vision": summarize(by_mod["vision"]),
            "ttft_text": summarize(by_mod["text"]),
            "tpot": self.tpot_summary(),
            "ib_global": self.ib_summary(),
            "ib_global_prefill": self.ib_summary("prefill"),
            "gate_duty_prefill": self.gate_duty("prefill"),
            "gate_duty_decode": self.gate_duty("decode"),
            "fp4_duty": self.fp4_duty(),
            "fp4_duty_prefill": self.fp4_duty("prefill"),
            "drop_frac": self.drop_summary(),
            "drop_frac_prefill": self.drop_summary("prefill"),
            "split_duty": self.split_duty(),
            "split_frac": self.split_summary(),
            "migration_bytes_total": self.migration_bytes_total,
            "migration_s_total": self.migration_s_total,
            # explicit stall/hidden split: migration_s IS the stall; the
            # hidden share is the transfer time async overlap absorbed
            "migration_stall_s": self.migration_s_total,
            "migration_hidden_s": self.migration_hidden_s_total,
            # "n_migrations" kept for old readers; it counts *iterations*
            # that carried migration traffic (one per async chunk batch),
            # NOT committed plans — the two unambiguous names:
            "n_migrations": self.n_migrations,
            "n_migration_iters": self.n_migrations,
            "n_plans_committed": self.n_plans_committed,
            # elastic serving: availability + recovery time
            "availability": self.availability,
            "degraded_iters": self.degraded_iters,
            "lost_tokens_total": self.lost_tokens_total,
            "n_recoveries": len(recoveries),
            # recovery_s stays the max (worst recovery) for old readers;
            # "recovery" carries the full percentile summary
            "recovery_s": max(recoveries) if recoveries else None,
            "recovery": summarize(recoveries),
            "expert_load_heatmap": self.heatmap.summary(),
            "prediction_accuracy": self.prediction.summary(),
            **self._profiler_summary(),
        }

    def _profiler_summary(self) -> Dict[str, object]:
        """Profiler-fed registry metrics, when a Profiler shares this
        registry (empty otherwise — legacy readers see no new keys on
        unprofiled runs, and the keys above never change meaning)."""
        reg = self.registry
        mfu = reg.get("mfu")
        if mfu is None or mfu.value() is None:
            return {}
        out: Dict[str, object] = {"mfu": float(mfu.value())}
        roof = reg.get("roofline_fraction")
        if roof is not None and roof.value() is not None:
            out["roofline_fraction"] = float(roof.value())
        scale = reg.get("costmodel_time_scale")
        if scale is not None and scale.value() is not None:
            out["costmodel_time_scale"] = float(scale.value())
        flops = reg.get("model_flops")
        if flops is not None:
            out["model_flops_total"] = float(flops.total())
        for name in ("phase_seconds", "phase_seconds_pred"):
            ctr = reg.get(name)
            if ctr is not None:
                out[name] = {k[0]: float(ctr.value(phase=k[0]))
                             for k in ctr.labelsets()}
        return out

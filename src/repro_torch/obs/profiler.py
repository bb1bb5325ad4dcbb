"""Hot-loop profiler: per-phase time attribution + costmodel drift.

Counterpart of ``repro.obs.profiler``.  Three jobs, one object:

1. **Phase attribution.**  Every recorded engine iteration feeds
   :meth:`Profiler.observe_iter` with the realized routing stats and the
   forward's measured seconds on the engine clock (a virtual-clock charge,
   or wall seconds).  The :class:`~repro_torch.obs.ledger.FlopByteLedger`
   turns the stats into analytic per-phase seconds, and the measured time
   is attributed to phases in proportion to them, so ``sum(phase seconds)
   == forward seconds`` by construction.  The engine takes a forward's
   seconds from its start to its statistics on the host, so on the card
   they hold the device's work, which finishes behind a forward (or a
   CUDA graph's replay) that returns once enqueued.  Unattributed
   per-phase times come from :func:`time_moe_phases`.
2. **MFU / roofline gauges.**  Cumulative ledger flops over cumulative
   measured forward seconds against the hardware record's bf16 peak, and
   the compute share of the roofline bound (compute vs HBM vs link
   bytes), pushed into a :class:`~repro_torch.obs.metrics.MetricsRegistry`
   (``mfu``, ``roofline_fraction``) so ``Telemetry.summary()`` carries
   them.
3. **Costmodel drift.**  ``time_scale()`` is the EWMA of measured-over-
   predicted iteration seconds — the factor a replan cost gate
   (``time_scale``) multiplies predicted savings by.  Per-phase drift
   ratios (cumulative measured / predicted) land in ``costmodel_drift``.

Instrumented mode (:func:`time_moe_phases`) runs the MoE layer as
cumulative *prefixes* (``stop_stage`` in ``core/ep_moe.py``), timing each
(CUDA events on the card, ``perf_counter`` on the CPU); a phase's time is
the difference of adjacent prefix times.  The full prefix is the layer
itself, so its output equals ``ep_moe_forward``'s bit for bit.  Prefix
times are standalone costs: the ``dispatch + quantize_fp4`` share is the
number the FP4 kernels must shrink.

Disabled profiling is the tracer's null object: :data:`NULL_PROFILER`
reads no clock and converts nothing, and an engine without a profiler
gives the same outputs bit for bit.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.launch.roofline import roofline_terms
from repro_torch.obs.ledger import PHASES, FlopByteLedger, IterLedger

#: MoE phase order of the instrumented prefixes, per dispatch mode.
MOE_STAGES = {
    "dispatch": ("route", "weight_gather", "quantize_fp4", "dispatch",
                 "expert_gemm", "combine"),
    "broadcast": ("route", "weight_gather", "quantize_fp4",
                  "expert_gemm", "combine"),
}

PROFILE_SCHEMA = "repro.profile.v1"


class NullProfiler:
    """Shared no-op: the engine's default when no profiler is wired."""
    enabled = False

    def observe_iter(self, *a, **kw) -> None:
        pass

    def time_scale(self) -> float:
        return 1.0

    def mfu(self) -> float:
        return 0.0

    def span_args(self) -> Dict[str, Any]:
        return {}


NULL_PROFILER = NullProfiler()


class Profiler:
    """Per-iteration phase/FLOP/drift accounting around a ledger.

    ``registry`` (optional): a :class:`~repro_torch.obs.metrics.
    MetricsRegistry` — pass the telemetry's so the gauges surface in its
    ``summary()``.  ``clock`` is unused for attribution (the engine passes
    measured ``fwd_s``).  ``ewma_alpha`` smooths ``time_scale``.  MFU and
    the roofline fraction price against ``ledger.hw``.
    """
    enabled = True

    def __init__(self, ledger: FlopByteLedger,
                 registry=None, clock: Optional[Callable[[], float]] = None,
                 ewma_alpha: float = 0.25):
        self.ledger = ledger
        self.registry = registry
        self.clock = clock
        self.alpha = float(ewma_alpha)
        self.n_iters = 0
        self.fwd_s_total = 0.0
        self.model_flops_total = 0.0
        self.flops_total = 0.0
        # fractional bytes: FP4 weights price at 4.25 bits a weight, so
        # these are analytic totals, not buffer sizes
        self.hbm_bytes_total = 0.0  # repro-lint: disable=RPL006
        self.ici_bytes_total = 0.0  # repro-lint: disable=RPL006
        self._meas_s = {ph: 0.0 for ph in PHASES}
        self._pred_s = {ph: 0.0 for ph in PHASES}
        self._scale_ewma: Optional[float] = None
        self.last: Optional[IterLedger] = None
        if registry is not None:
            self._g_mfu = registry.gauge(
                "mfu", "model flops / (measured s * peak bf16)")
            self._g_roof = registry.gauge(
                "roofline_fraction", "compute share of the roofline bound")
            self._g_scale = registry.gauge(
                "costmodel_time_scale", "EWMA measured/predicted iter s")
            self._g_drift = registry.gauge(
                "costmodel_drift", "cumulative measured/predicted per phase",
                labels=("phase",))
            self._c_flops = registry.counter(
                "model_flops", "cumulative useful model flops")
            self._c_phase = registry.counter(
                "phase_seconds", "measured seconds attributed per phase",
                labels=("phase",))
            self._c_pred = registry.counter(
                "phase_seconds_pred", "ledger-predicted seconds per phase",
                labels=("phase",))

    # --------------------------------------------------------------------
    def observe_iter(self, *, moe_stats, fp4_layers: float, tokens: float,
                     batch_tokens: float, fwd_s: float,
                     phase: str = "decode",
                     measured_phases: Optional[Dict[str, float]] = None
                     ) -> IterLedger:
        """Account one recorded iteration (host numpy ``moe_stats``).

        Without ``measured_phases`` the forward seconds are attributed by
        the ledger's predicted shares; an instrumented caller may pass
        real per-phase seconds, rescaled to sum to ``fwd_s``."""
        led = self.ledger.account(moe_stats, fp4_layers, tokens,
                                  batch_tokens)
        self.last = led
        self.n_iters += 1
        fwd_s = max(float(fwd_s), 0.0)
        self.fwd_s_total += fwd_s
        self.model_flops_total += led.model_flops
        self.flops_total += led.flops_total
        self.hbm_bytes_total += led.hbm_total
        self.ici_bytes_total += led.ici_total

        weights = dict(measured_phases) if measured_phases else led.pred_s
        wtot = sum(max(v, 0.0) for v in weights.values())
        for ph in PHASES:
            self._pred_s[ph] += led.pred_s[ph]
            share = (max(weights.get(ph, 0.0), 0.0) / wtot) if wtot > 0 \
                else 1.0 / len(PHASES)
            self._meas_s[ph] += fwd_s * share

        pred_total = led.pred_total
        if pred_total > 0 and fwd_s > 0:
            r = fwd_s / pred_total
            self._scale_ewma = r if self._scale_ewma is None else (
                self.alpha * r + (1.0 - self.alpha) * self._scale_ewma)

        if self.registry is not None:
            self._g_mfu.set(self.mfu())
            self._g_roof.set(self.roofline_fraction())
            self._g_scale.set(self.time_scale())
            self._c_flops.inc(led.model_flops)
            for ph in PHASES:
                self._c_phase.inc(fwd_s * (
                    (max(weights.get(ph, 0.0), 0.0) / wtot) if wtot > 0
                    else 1.0 / len(PHASES)), phase=ph)
                if led.pred_s[ph] > 0:
                    self._c_pred.inc(led.pred_s[ph], phase=ph)
                if self._pred_s[ph] > 0:
                    self._g_drift.set(
                        self._meas_s[ph] / self._pred_s[ph], phase=ph)
        return led

    # -- derived quantities ----------------------------------------------
    def mfu(self) -> float:
        if self.fwd_s_total <= 0:
            return 0.0
        return self.model_flops_total / (self.fwd_s_total
                                         * self.ledger.hw.peak_bf16)

    def roofline_fraction(self) -> float:
        if self.flops_total <= 0:
            return 0.0
        return roofline_terms(self.flops_total, self.hbm_bytes_total,
                              self.ici_bytes_total,
                              self.ledger.hw)["roofline_fraction"]

    def time_scale(self) -> float:
        """EWMA of measured/predicted iteration seconds (1.0 until the
        first observation) — the cost gates' savings-side calibration."""
        return 1.0 if self._scale_ewma is None else float(self._scale_ewma)

    def phase_seconds(self) -> Dict[str, float]:
        return dict(self._meas_s)

    def phase_seconds_pred(self) -> Dict[str, float]:
        return dict(self._pred_s)

    def drift(self) -> Dict[str, float]:
        """Cumulative measured/predicted ratio per phase (1.0 when the
        phase never carried predicted time)."""
        return {ph: (self._meas_s[ph] / self._pred_s[ph]
                     if self._pred_s[ph] > 0 else 1.0) for ph in PHASES}

    def span_args(self) -> Dict[str, Any]:
        """Per-iteration metadata for the engine's ``iter`` trace span."""
        if self.last is None:
            return {}
        return {"mfu": round(self.mfu(), 6),
                "model_flops": self.last.model_flops,
                "pred_s": round(self.last.pred_total, 9)}

    def summary(self) -> Dict[str, Any]:
        return {
            "n_iters": self.n_iters,
            "mfu": self.mfu(),
            "roofline_fraction": self.roofline_fraction(),
            "time_scale": self.time_scale(),
            "model_flops_total": self.model_flops_total,
            "flops_total": self.flops_total,
            "hbm_bytes_total": self.hbm_bytes_total,
            "ici_bytes_total": self.ici_bytes_total,
            "forward_s_total": self.fwd_s_total,
            "phase_seconds": self.phase_seconds(),
            "phase_seconds_pred": self.phase_seconds_pred(),
            "drift": self.drift(),
        }

    def write(self, path: str, metadata: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
        """Write the profile JSON (the reference's schema)."""
        doc = {
            "schema": PROFILE_SCHEMA,
            "metadata": dict(metadata or {}),
            "n_iters": self.n_iters,
            "phases": {ph: {"measured_s": self._meas_s[ph],
                            "predicted_s": self._pred_s[ph]}
                       for ph in PHASES},
            "totals": {
                "forward_s": self.fwd_s_total,
                "predicted_s": sum(self._pred_s.values()),
                "model_flops": self.model_flops_total,
                "flops": self.flops_total,
                "hbm_bytes": self.hbm_bytes_total,
                "ici_bytes": self.ici_bytes_total,
                "mfu": self.mfu(),
                "roofline_fraction": self.roofline_fraction(),
                "time_scale": self.time_scale(),
            },
            "drift": self.drift(),
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc


# --------------------------------------------------------------------------
# instrumented execution mode: cumulative prefixes
# --------------------------------------------------------------------------
def _timer(device):
    """A function timing one call of ``fn`` in seconds: CUDA events around
    it on the current stream of a card, ``perf_counter`` on the CPU."""
    import torch
    if device.type == "cuda":
        def run(fn):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) * 1e-3, out
        return run

    def run(fn):
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out
    return run


def time_moe_phases(p, x, cfg, rcfg, m_state, *, mode: str = "dispatch",
                    modality=None, valid=None, placement=None,
                    repeats: int = 3, warmup: int = 1
                    ) -> Tuple[Dict[str, float], Any]:
    """Per-phase seconds of one MoE layer by prefix timing.

    Runs the layer once per cumulative ``stop_stage`` prefix, times each
    (the min over ``repeats`` after ``warmup`` runs; CUDA events on a
    card, ``perf_counter`` on the CPU) and reports ``phase[k] =
    t(prefix_k) − t(prefix_{k−1})`` clamped at zero.  Returns
    ``(phase_seconds, full_output)``: the last prefix's ``(y, m_new,
    aux)``, equal bit for bit to ``ep_moe_forward`` on the same inputs.

    Under ReaLB-seq (``rcfg.overlap=False``) the transformation's cost
    lands in the ``dispatch`` phase, as in the reference."""
    from repro_torch.core import ep_moe

    stages = MOE_STAGES[mode]
    timed = _timer(x.device)

    def measure(stop):
        def fn():
            return ep_moe.ep_moe_forward(
                p, x, cfg, rcfg, m_state, modality=modality, valid=valid,
                mode=mode, placement=placement, stop_stage=stop)
        out = None
        for _ in range(max(warmup, 1)):
            _, out = timed(fn)
        best = float("inf")
        for _ in range(max(repeats, 1)):
            t, out = timed(fn)
            best = min(best, t)
        return best, out

    seconds: Dict[str, float] = {}
    prev = 0.0
    full_out = None
    for stage in stages:
        stop = None if stage == stages[-1] else stage
        t, out = measure(stop)
        seconds[stage] = max(t - prev, 0.0)
        prev = max(t, prev)
        if stop is None:
            full_out = out
    return seconds, full_out

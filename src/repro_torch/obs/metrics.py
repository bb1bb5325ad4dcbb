"""Typed metrics registry + serving-specific recorders.

Copy of ``repro.obs.metrics`` (numpy and the stdlib only), kept in the
port because the reference's ``obs`` package imports jax on import.

The registry gives the serving stack one vocabulary for numbers that
are not per-iteration time series: **counters** (monotonic cumulative
sums — bytes migrated, plans committed), **gauges** (last-written
values — current capacity factor), and **histograms** (bounded sample
windows summarized as percentiles — recovery seconds).  Metrics carry
declared label names; a labeled metric holds one value per label-value
tuple, so e.g. one ``replan_decisions`` counter covers every verdict
kind without a metric per verdict.

Two domain recorders build on the same percentile math:

- :class:`HeatmapRecorder` — per-layer per-rank expert-load occupancy
  from the ``[L, E]`` expert stats (or exact ``[L, slots]`` slot stats)
  already threaded through the scan, folded to rank totals by the live
  placement/replication tables.
- :class:`PredictionTracker` — the predicted-vs-realized peak-rank-load
  accuracy metric (ROADMAP item 5's bake-off criterion): each committed
  replan opens a window stamped with the predictor's per-layer rank
  loads; realized loads accumulate until the next commit; the window
  closes with per-layer |predicted − realized| peak-share errors.

``percentile`` / ``summarize`` live here (dependency-light, directly
unit-tested) and are re-exported by ``repro_torch.serving.telemetry``.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy 'linear' method).

    q in [0, 100].  Defined locally (not np.percentile) so the telemetry
    math is dependency-light and directly unit-tested.
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q out of range: {q}")
    xs = sorted(xs)
    if not xs:
        raise ValueError("percentile of empty sequence")
    if len(xs) == 1:
        return float(xs[0])
    rank = (q / 100.0) * (len(xs) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


def summarize(xs: Sequence[float], qs=(50, 90, 99)) -> Dict[str, float]:
    """{"p50": ..., "p90": ..., ...} plus mean; empty input -> {}."""
    xs = list(xs)
    if not xs:
        return {}
    out = {f"p{int(q)}": percentile(xs, q) for q in qs}
    out["mean"] = sum(xs) / len(xs)
    return out


class _Metric:
    """Shared label plumbing: values keyed by label-value tuples."""
    kind = "metric"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._data: Dict[Tuple, Any] = {}

    def _key(self, kw: Dict[str, Any]) -> Tuple:
        if tuple(sorted(kw)) != tuple(sorted(self.labels)):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labels}, "
                f"got {tuple(sorted(kw))}")
        return tuple(kw[k] for k in self.labels)

    def labelsets(self) -> List[Tuple]:
        return list(self._data)

    def _fmt_key(self, key: Tuple) -> str:
        return ",".join(f"{k}={v}" for k, v in zip(self.labels, key))


class Counter(_Metric):
    """Monotonic cumulative sum.  Integer-valued increments keep the
    stored value integral (byte counters stay exact ints)."""
    kind = "counter"

    def inc(self, amount=1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r}: negative inc")
        key = self._key(labels)
        self._data[key] = self._data.get(key, 0) + amount

    def value(self, **labels):
        return self._data.get(self._key(labels), 0)

    def total(self):
        """Sum over every labelset (0 when never incremented)."""
        return sum(self._data.values()) if self._data else 0

    def snapshot(self) -> Any:
        if not self.labels:
            return self.value()
        return {self._fmt_key(k): v for k, v in sorted(self._data.items())}


class Gauge(_Metric):
    """Last-written value per labelset."""
    kind = "gauge"

    def set(self, value, **labels) -> None:
        self._data[self._key(labels)] = value

    def value(self, default=None, **labels):
        return self._data.get(self._key(labels), default)

    def snapshot(self) -> Any:
        if not self.labels:
            return self.value()
        return {self._fmt_key(k): v for k, v in sorted(self._data.items())}


class Histogram(_Metric):
    """Sample collector summarized as percentiles.

    ``window=None`` keeps every observation (recoveries: a handful per
    run); a finite window bounds memory like telemetry's deques."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Sequence[str] = (),
                 window: Optional[int] = None):
        super().__init__(name, help, labels)
        self.window = window

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        bucket = self._data.get(key)
        if bucket is None:
            bucket = deque(maxlen=self.window) if self.window else []
            self._data[key] = bucket
        bucket.append(float(value))

    def values(self, **labels) -> List[float]:
        return list(self._data.get(self._key(labels), ()))

    def count(self, **labels) -> int:
        return len(self._data.get(self._key(labels), ()))

    def summary(self, qs=(50, 90, 99), **labels) -> Dict[str, float]:
        return summarize(self.values(**labels), qs=qs)

    def snapshot(self) -> Any:
        def one(bucket):
            s = summarize(list(bucket))
            s["count"] = len(bucket)
            if bucket:
                s["max"] = max(bucket)
            return s
        if not self.labels:
            return one(self._data.get((), ()))
        return {self._fmt_key(k): one(v)
                for k, v in sorted(self._data.items())}


class MetricsRegistry:
    """Register-or-get home for every metric; one per Telemetry."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_make(self, cls, name, help, labels, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls or m.labels != tuple(labels):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{m.kind}{m.labels}")
            return m
        m = cls(name, help=help, labels=labels, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  window: Optional[int] = None) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels,
                                 window=window)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """Flat {metric-name: value/summary} dict, JSON-serializable."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}


def _as_2d(x) -> np.ndarray:
    a = np.asarray(x, dtype=np.float64)
    return a[None, :] if a.ndim == 1 else a


class HeatmapRecorder:
    """Per-layer per-rank expert-load occupancy over the run.

    Feed one ``[L, R]`` rank-load matrix per iteration (tokens routed to
    each rank's experts at each layer).  Keeps the cumulative sum, the
    last matrix, and every ``every``-th iteration a normalized snapshot
    in a bounded deque — enough to see skew drift without storing the
    full time series.
    """

    def __init__(self, every: int = 32, keep: int = 8):
        self.every = max(int(every), 1)
        self.keep = keep
        self.n_records = 0
        self._sum: Optional[np.ndarray] = None
        self.last: Optional[np.ndarray] = None
        self.snapshots: Deque[Dict[str, Any]] = deque(maxlen=keep)

    def record(self, heatmap) -> None:
        hm = _as_2d(heatmap)
        if self._sum is None or self._sum.shape != hm.shape:
            # shape change (elastic resize / first record) restarts the
            # accumulation — a mixed-geometry sum would be meaningless
            self._sum = np.zeros_like(hm)
            self.n_records = 0
            self.snapshots.clear()
        self._sum += hm
        self.last = hm
        self.n_records += 1
        if self.n_records % self.every == 0:
            self.snapshots.append({"n": self.n_records,
                                   "share": self.shares().tolist()})

    def shares(self) -> np.ndarray:
        """Cumulative ``[L, R]`` with each layer row normalized to 1
        (zero rows stay zero)."""
        if self._sum is None:
            return np.zeros((0, 0))
        rows = self._sum.sum(axis=1, keepdims=True)
        return np.divide(self._sum, np.where(rows > 0, rows, 1.0))

    def summary(self) -> Dict[str, Any]:
        if self._sum is None or self.n_records == 0:
            return {}
        share = self.shares()
        L, R = share.shape
        peak = share.max(axis=1)
        # max/mean ratio per layer: 1.0 = perfectly balanced, R = one
        # rank took everything
        imbalance = peak * R
        rank_total = self._sum.sum(axis=0)
        tot = rank_total.sum()
        return {
            "n_records": self.n_records,
            "layers": L,
            "ranks": R,
            "rank_share": (rank_total / tot if tot > 0
                           else rank_total).tolist(),
            "layer_peak_rank": share.argmax(axis=1).tolist(),
            "layer_peak_share": peak.tolist(),
            "imbalance_mean": float(imbalance.mean()),
            "imbalance_max": float(imbalance.max()),
            "share": share.tolist(),
            "n_snapshots": len(self.snapshots),
        }


class PredictionTracker:
    """Predicted-vs-realized peak-rank load per replan window, per layer.

    Protocol: on each committed replan the manager predicts per-layer
    rank loads for the fresh tables; :meth:`open` stamps them and closes
    the previous window.  Every iteration's realized ``[L, R]`` rank
    loads accumulate via :meth:`record`.  A window's per-layer error is
    ``|predicted peak-rank share − realized peak-rank share|`` plus
    whether the predicted peak rank was the realized one — exactly the
    quantity the cost gate trusted when it priced the migration.
    """

    def __init__(self):
        self.windows: List[Dict[str, Any]] = []
        self._open_it: Optional[int] = None
        self._pred: Optional[np.ndarray] = None
        self._acc: Optional[np.ndarray] = None
        self._n_acc = 0

    def open(self, it: int, predicted) -> None:
        """Close any open window and start one at iteration ``it`` with
        the predictor's per-layer rank loads (``[L, R]`` or ``[R]``)."""
        self._close(end_it=int(it))
        if predicted is None:
            return
        self._open_it = int(it)
        self._pred = _as_2d(predicted)
        self._acc = np.zeros_like(self._pred)
        self._n_acc = 0

    def record(self, realized) -> None:
        if self._pred is None:
            return
        r = _as_2d(realized)
        if self._acc.shape[0] == 1 and r.shape[1:] == self._acc.shape[1:]:
            # a shared-table prediction is one depth-aggregated row;
            # fold the per-layer realized loads the same way
            r = r.sum(axis=0, keepdims=True)
        if r.shape != self._acc.shape:
            return                      # geometry changed mid-window
        self._acc += r
        self._n_acc += 1

    def _window_stats(self, end_it: Optional[int]) -> Optional[Dict]:
        if self._pred is None or self._n_acc == 0:
            return None
        per_layer = []
        for l in range(self._pred.shape[0]):
            p, r = self._pred[l], self._acc[l]
            if p.sum() <= 0 or r.sum() <= 0:
                continue
            ps, rs = p / p.sum(), r / r.sum()
            per_layer.append({
                "layer": l,
                "pred_peak_share": float(ps.max()),
                "real_peak_share": float(rs.max()),
                "abs_err": float(abs(ps.max() - rs.max())),
                "rank_match": bool(ps.argmax() == rs.argmax()),
            })
        if not per_layer:
            return None
        return {"start_it": self._open_it, "end_it": end_it,
                "n_iters": self._n_acc, "per_layer": per_layer}

    def _close(self, end_it: Optional[int]) -> None:
        w = self._window_stats(end_it)
        if w is not None:
            self.windows.append(w)
        self._open_it = self._pred = self._acc = None
        self._n_acc = 0

    def summary(self) -> Dict[str, Any]:
        """Aggregate over closed windows plus the open one (virtually
        closed — :meth:`record` keeps working afterwards)."""
        ws = list(self.windows)
        virt = self._window_stats(end_it=None)
        if virt is not None:
            ws.append(virt)
        if not ws:
            return {}
        rows = [pl for w in ws for pl in w["per_layer"]]
        return {
            "n_windows": len(ws),
            "n_iters_observed": sum(w["n_iters"] for w in ws),
            "pred_peak_share_mean": float(np.mean(
                [r["pred_peak_share"] for r in rows])),
            "real_peak_share_mean": float(np.mean(
                [r["real_peak_share"] for r in rows])),
            "peak_share_abs_err": summarize(
                [r["abs_err"] for r in rows], qs=(50, 90)),
            "rank_match_frac": float(np.mean(
                [1.0 if r["rank_match"] else 0.0 for r in rows])),
        }

"""Low-overhead span tracer with Chrome-trace (Perfetto) JSON export.

The serving stack answers "where inside the iteration did the time go"
with *nested spans*: the engine opens one ``iter`` span per serving
iteration and nests admission / chunk-forward / decode / migration-drain
/ table-commit spans inside it; the managers wrap their planning, the
:class:`~repro_torch.serving.async_migrate.MigrationExecutor` wraps each chunk
batch, the reference's elastic coordinator stamps its
events as instants.  Spans read the *engine clock* — under the virtual
clock of a seeded benchmark run the whole trace is deterministic and
CI-diffable; under wall clocks it is an honest profile.

Zero-cost when disabled: :data:`NULL_TRACER` is a shared singleton whose
``span``/``instant``/``complete`` are no-ops returning one cached null
span — no dict allocation, no clock read, nothing recorded — so an
engine built without a tracer is bitwise identical to one predating the
obs layer.  Hot loops guard annotation work with ``tracer.enabled``.

Export follows the Chrome Trace Event format (the JSON Perfetto and
``chrome://tracing`` load): ``X`` complete events with microsecond
``ts``/``dur``, ``i`` instants, one process/thread.  Extra run metadata
rides in the top-level ``metadata`` object (ignored by viewers, read by
``benchmarks/trace_report.py`` for stall-vs-hidden reconciliation).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional


class Span:
    """One open span; annotate with :meth:`set`, close via ``with``."""
    __slots__ = ("_tracer", "name", "cat", "t0", "args")

    def __init__(self, tracer: "Tracer", name: str, cat: str):
        self._tracer = tracer
        self.name, self.cat = name, cat
        self.t0 = 0.0
        self.args: Optional[Dict[str, Any]] = None

    def set(self, **kw) -> "Span":
        """Attach args shown in the trace viewer (numbers/strings)."""
        if self.args is None:
            self.args = kw
        else:
            self.args.update(kw)
        return self

    def __enter__(self) -> "Span":
        self.t0 = self._tracer.clock()
        self._tracer._depth += 1
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        tr._depth -= 1
        tr._events.append(("X", self.name, self.cat, self.t0,
                           tr.clock() - self.t0, self.args))
        return False


class _NullSpan:
    """The shared do-nothing span of :class:`NullTracer`."""
    __slots__ = ()

    def set(self, **kw) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracing disabled: every call is a no-op on shared singletons.

    ``enabled`` is the hot-loop guard — code computing span annotations
    checks it first so a disabled tracer costs one attribute read."""
    enabled = False

    def span(self, name: str, cat: str = "serving") -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, cat: str = "serving",
                args: Optional[Dict[str, Any]] = None) -> None:
        pass

    def complete(self, name: str, t0: float, dur: float,
                 cat: str = "serving",
                 args: Optional[Dict[str, Any]] = None) -> None:
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Records spans/instants against ``clock`` (seconds; the engine's
    virtual clock for deterministic traces, ``time.perf_counter`` for
    wall profiles)."""
    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock if clock is not None else time.perf_counter
        # (ph, name, cat, t0_s, dur_s, args) tuples; instants carry
        # dur_s=0.  Append-only in program order => deterministic.
        self._events: List[tuple] = []
        self._depth = 0

    def span(self, name: str, cat: str = "serving") -> Span:
        return Span(self, name, cat)

    def instant(self, name: str, cat: str = "serving",
                args: Optional[Dict[str, Any]] = None) -> None:
        self._events.append(("i", name, cat, self.clock(), 0.0, args))

    def complete(self, name: str, t0: float, dur: float,
                 cat: str = "serving",
                 args: Optional[Dict[str, Any]] = None) -> None:
        """Append an already-measured span (e.g. a migration drain whose
        duration is the stall+hidden attribution, not two clock reads)."""
        self._events.append(("X", name, cat, float(t0), float(dur), args))

    def __len__(self) -> int:
        return len(self._events)

    # -- export ------------------------------------------------------------
    def to_chrome(self, metadata: Optional[Dict[str, Any]] = None) -> Dict:
        """The Chrome Trace Event JSON object (Perfetto-loadable)."""
        events: List[Dict[str, Any]] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "repro_torch.serving"}},
            {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
             "args": {"name": "engine"}},
        ]
        for ph, name, cat, t0, dur, args in self._events:
            ev: Dict[str, Any] = {"ph": ph, "pid": 0, "tid": 0,
                                  "name": name, "cat": cat,
                                  "ts": t0 * 1e6}
            if ph == "X":
                ev["dur"] = max(dur, 0.0) * 1e6
            else:                              # instant: thread scope
                ev["s"] = "t"
            if args:
                ev["args"] = args
            events.append(ev)
        out: Dict[str, Any] = {"traceEvents": events,
                               "displayTimeUnit": "ms"}
        if metadata:
            out["metadata"] = metadata
        return out

    def write(self, path: str,
              metadata: Optional[Dict[str, Any]] = None) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(metadata), f, indent=1, default=float)
        return path


def validate_chrome_trace(obj: Dict) -> List[Dict]:
    """Schema-check a Chrome-trace object; returns its event list.

    Raises ``ValueError`` on structural problems — the CI trace artifact
    must stay loadable by Perfetto across refactors."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a Chrome trace: missing 'traceEvents'")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' is not a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i", "M", "B", "E", "C"):
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        if "name" not in ev:
            raise ValueError(f"event {i}: missing 'name'")
        if ph in ("X", "i"):
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)):
                raise ValueError(f"event {i}: missing numeric 'ts'")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: 'X' needs dur >= 0, "
                                 f"got {dur!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i}: 'args' is not an object")
    return events


def load_trace(path: str) -> Dict:
    """Load + validate a trace file written by :meth:`Tracer.write`."""
    with open(path) as f:
        obj = json.load(f)
    validate_chrome_trace(obj)
    return obj

"""Replan-decision audit log.

Every ``ReplanDiscipline.maybe_replan`` call ends in exactly one
verdict; the audit log records it as one structured event so a run can
answer "why did the planner (not) replan at iteration N" after the
fact.  Verdicts and their extra fields:

- ``no-cadence`` / ``disabled`` / ``in-flight`` / ``blocked`` /
  ``warmup`` / ``already-replanned`` — the cadence gate said no (the
  reason is the verdict itself).
- ``zero-load`` — cadence hit but the predictor had nothing to plan on.
- ``min-gain`` — predicted gain below ``min_gain`` (fields:
  ``pred_gain``).
- ``noop`` — planner produced the current layout (per-layer: every
  per-layer plan was a noop or churn-budget-trimmed away; fields:
  ``changed_layers=0``).
- ``cost-gate`` — the analytic gate rejected the priced plan (fields:
  ``pred_gain``, ``migration_bytes``, ``migration_s``, ``n_moved``).
- ``staged`` — plan accepted and staged for (a)synchronous application
  (same pricing fields, plus ``changed_layers`` and ``must`` for
  elastic must-plans).

Events carry a monotone ``seq`` (program order, deterministic under the
virtual clock), the iteration, the manager kind (``placement`` /
``replication``), and the cadence ``regime`` (``mixed`` / ``decode``)
when one fired.
"""
from __future__ import annotations

import json
from collections import Counter as _TallyCounter
from typing import Any, Dict, List, Optional


class ReplanAudit:
    """Append-only decision log shared by both managers of a run."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []

    def record(self, *, it: int, manager: str, verdict: str,
               regime: Optional[str] = None, **fields) -> Dict[str, Any]:
        ev: Dict[str, Any] = {"seq": len(self.events), "it": int(it),
                              "manager": manager, "verdict": verdict}
        if regime is not None:
            ev["regime"] = regime
        for k, v in fields.items():
            if v is not None:
                ev[k] = v
        self.events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self.events)

    # -- queries -----------------------------------------------------------
    def query(self, *, manager: Optional[str] = None,
              verdict: Optional[str] = None,
              it: Optional[int] = None) -> List[Dict[str, Any]]:
        out = self.events
        if manager is not None:
            out = [e for e in out if e["manager"] == manager]
        if verdict is not None:
            out = [e for e in out if e["verdict"] == verdict]
        if it is not None:
            out = [e for e in out if e["it"] == it]
        return list(out)

    def counts(self, by: str = "verdict") -> Dict[str, int]:
        """Tally events by any field (missing field -> 'none')."""
        tally = _TallyCounter(str(e.get(by, "none")) for e in self.events)
        return dict(sorted(tally.items()))

    def cadence_hits(self) -> List[Dict[str, Any]]:
        """Events where the cadence gate opened (a plan was attempted):
        everything past the cheap cadence rejections."""
        skip = {"no-cadence", "disabled", "in-flight", "blocked",
                "warmup", "already-replanned"}
        return [e for e in self.events if e["verdict"] not in skip]

    # -- export ------------------------------------------------------------
    def to_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev, default=float) + "\n")
        return path

    @staticmethod
    def load_jsonl(path: str) -> List[Dict[str, Any]]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

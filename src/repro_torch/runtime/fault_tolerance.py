"""Scripted rank faults for elastic serving.

Counterpart of ``repro.runtime.fault_tolerance``'s :class:`FaultEvent`
and :class:`FaultInjector`; the reference's fault-tolerant training loop
(``TrainLoop``) belongs to the training slice of the port.
"""
from __future__ import annotations


class FaultEvent:
    """One scripted rank fault: ``kind`` is 'fail' or 'rejoin'."""

    __slots__ = ("it", "kind", "rank")

    def __init__(self, it: int, kind: str, rank: int):
        assert kind in ("fail", "rejoin"), kind
        self.it, self.kind, self.rank = int(it), kind, int(rank)

    def __repr__(self):
        return f"FaultEvent(it={self.it}, kind={self.kind!r}, " \
               f"rank={self.rank})"


class FaultInjector:
    """Deterministic scripted rank-fault schedule for serving.

    The engine polls :meth:`due` once per iteration and dispatches the
    returned events to its elastic coordinator (``fail_rank`` /
    ``rejoin_rank``).  Events are (iteration, kind, rank) triples, e.g.
    ``FaultInjector([(40, "fail", 2), (90, "rejoin", 2)])``.
    """

    def __init__(self, events):
        evs = [e if isinstance(e, FaultEvent) else FaultEvent(*e)
               for e in events]
        self.events = sorted(evs, key=lambda e: e.it)
        self._i = 0

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self.events)

    def due(self, it: int):
        """Events scheduled at or before ``it`` that have not fired yet
        (each event fires exactly once, in schedule order)."""
        out = []
        while self._i < len(self.events) and self.events[self._i].it <= it:
            out.append(self.events[self._i])
            self._i += 1
        return out

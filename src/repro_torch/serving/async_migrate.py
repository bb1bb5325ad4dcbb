"""Asynchronous overlapped migration: per-layer slab streaming with
measured-bandwidth budgeting (HarMoEny-style layer-wise rebalancing).

The synchronous migration path applies a staged plan's entire slab
permutation between two serving iterations — a hard stall proportional
to the whole transfer.  This module turns a staged (layer-diff) plan
into a queue of per-layer :class:`SlabChunk` s and drains a
*byte-budgeted* batch of chunks per serving iteration instead:

- **chunking** — each changed layer of a
  :class:`~repro_torch.placement.migrate.LayerMigrationPlan` /
  :class:`~repro_torch.replication.migrate.LayerReplicaMigrationPlan` is one
  chunk (a shared plan degenerates to a single whole-plan chunk);
- **budgeting** — the per-iteration byte budget is either explicit
  (``bytes_per_iter``) or derived from the manager's *measured*
  bytes/s EWMA (:class:`~repro_torch.placement.migrate.MigrationBandwidth`)
  times the engine's recent iteration seconds: the bytes that fit under
  one iteration's compute, i.e. the transfer the overlap can hide;
- **calibration** — every drained batch's ``apply_to_params`` wall
  clock is timed (synchronized on the weights' device) and fed back into
  the bandwidth EWMA, which also prices ``manager.migration_seconds`` and
  the reference's ``benchmarks.costmodel.CalibratedReplanCostGate``;
- **per-layer commit** — as each chunk lands, exactly that layer's
  table is committed (``manager.commit_layers``), so serving keeps
  routing through the *old* table for layers whose slab has not landed
  and through the *new* table for layers that have.  The consistency
  rule is preserved per layer: a layer's new table becomes routable
  only after its slab landed.

The executor is deliberately host-side and engine-agnostic: the engine
owns the clock accounting (stall vs. hidden seconds) and the decision
of when to drain; the executor owns the queue, the subset applies, the
timing and the per-layer commits.  The slab gathers are in place and run
on the forward's stream: the global-scale scratch of the quantizer exists
once per device, so a side stream would race it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from repro_torch.placement import migrate as pmigrate

# bytes the first drain may assume fit under one iteration when the
# engine has no iteration-seconds estimate yet (~2 ms of transfer)
DEFAULT_OVERLAP_S = 2e-3


@dataclasses.dataclass(frozen=True)
class SlabChunk:
    """One unit of overlap: a single layer's slab gather of a staged
    plan (layer 0 = the whole plan for shared, non-layer plans)."""
    layer: int
    nbytes: int


@dataclasses.dataclass(frozen=True)
class DrainReport:
    """What one per-iteration drain did (engine accounting input)."""
    layers: List[int]          # chunk layers landed this iteration
    nbytes: int                # logical transfer bytes of those chunks
    budget_bytes: int          # the budget the batch was packed against
    wall_s: float              # measured wall clock of the subset apply
    done: bool                 # queue empty: the plan has fully landed

    @property
    def excess_bytes(self) -> int:
        """Bytes past the budget (a single chunk larger than the budget
        is transferred whole for progress; the excess is *stall*)."""
        return max(0, self.nbytes - self.budget_bytes)


class MigrationExecutor:
    """Drains one staged plan as a queue of byte-budgeted slab chunks.

    Built by the engine when a manager stages a plan in async mode;
    ``drain`` is called once per serving iteration until ``draining`` is
    False.  Chunks are ordered by plan layer index — deeper layers land
    later, which matches the scan order but is otherwise arbitrary (the
    per-layer consistency rule makes any order safe).

    ``priority_layers`` (elastic recovery) moves those layers to the
    queue front: recovery chunks re-materializing unroutable experts
    drain before optimization chunks, under the same byte budget.
    ``undo`` is the gather taking the plan's layout back to the tables
    routable when the executor was built (the diff of the new tables
    against them): a batch that fails part-way runs it over the blocks it
    had landed."""

    def __init__(self, manager, plan,
                 bytes_per_iter: Optional[int] = None,
                 priority_layers=None, undo=None):
        self.manager = manager
        self.plan = plan
        self.undo = undo
        # explicit budget wins; otherwise measured bandwidth x overlap
        self.bytes_per_iter = None if not bytes_per_iter \
            else int(bytes_per_iter)
        self.queue: List[SlabChunk] = [
            SlabChunk(layer=l, nbytes=int(manager.layer_bytes(plan, l)))
            for l in manager.plan_layers(plan)]
        if priority_layers:
            prio = {int(l) for l in priority_layers}
            # stable: recovery chunks first, layer order preserved within
            # each class
            self.queue.sort(key=lambda c: c.layer not in prio)
        self.total_bytes = sum(c.nbytes for c in self.queue)
        self.drained_bytes = 0
        self.n_drains = 0

    @property
    def draining(self) -> bool:
        return bool(self.queue)

    def cancel(self) -> None:
        """Drop the remaining chunks and abort the staged plan (already
        committed layers stay routable — their slabs landed)."""
        self.queue.clear()
        self.manager.abort()

    def budget_bytes(self, iter_s: Optional[float] = None) -> int:
        """This iteration's byte budget: the explicit knob, or the bytes
        the measured bandwidth moves in one iteration's compute."""
        if self.bytes_per_iter is not None:
            return self.bytes_per_iter
        overlap = iter_s if iter_s and iter_s > 0 else DEFAULT_OVERLAP_S
        return max(int(self.manager.bandwidth.bytes_per_s * overlap), 1)

    def _pack(self, budget: int) -> List[SlabChunk]:
        """Pop a batch of chunks fitting the budget — always at least
        one, so an over-budget chunk still makes progress (its excess is
        charged as stall by the engine)."""
        batch = [self.queue.pop(0)]
        spent = batch[0].nbytes
        while self.queue and spent + self.queue[0].nbytes <= budget:
            batch.append(self.queue.pop(0))
            spent += batch[-1].nbytes
        return batch

    def drain(self, params: Dict[str, Any],
              iter_s: Optional[float] = None):
        """Apply one budgeted batch of chunks to ``params``; time the
        apply, feed the bandwidth EWMA, commit exactly the landed
        layers.  Returns ``(new_params, DrainReport)``.

        On an apply failure the staged plan is aborted and the error is
        re-raised: this batch's landed blocks are gathered back by
        ``undo``, so the old tables stay consistent with them, and layers
        committed by earlier batches stay routable (their slabs did
        land)."""
        assert self.queue, "drain of a fully-landed plan"
        budget = self.budget_bytes(iter_s)
        batch = self._pack(budget)
        layers = [c.layer for c in batch]
        nbytes = sum(c.nbytes for c in batch)
        t0 = time.perf_counter()
        landed: List = []
        try:
            new_params = pmigrate.apply_layers_to_params(
                params, self.plan, layers, landed)
            pmigrate.synchronize(new_params)
        except BaseException as err:
            self.queue.clear()
            pmigrate.roll_back(err, params, self.undo, landed,
                               self.manager.abort)
            raise
        wall = time.perf_counter() - t0
        self.manager.bandwidth.observe(nbytes, wall)
        trc = getattr(self.manager, "tracer", None)
        if trc is not None and trc.enabled:
            # the measured wall seconds of this batch's subset apply,
            # stamped at the current engine-clock position (the engine's
            # migration.drain spans carry the stall/hidden attribution)
            trc.complete("migration.apply", trc.clock(), wall,
                         cat="migration",
                         args={"layers": len(layers), "bytes": int(nbytes),
                               "budget_bytes": int(budget),
                               "wall_s": wall,
                               "remaining": len(self.queue)})
        self.manager.commit_layers(self.plan, layers)
        self.drained_bytes += nbytes
        self.n_drains += 1
        return new_params, DrainReport(layers=layers, nbytes=nbytes,
                                       budget_bytes=budget, wall_s=wall,
                                       done=not self.queue)

"""Replica ownership matrices (host side).

A :class:`ReplicaSet` generalizes the bijective
:class:`~repro_torch.placement.table.PlacementTable` to *redundant experts*:
each of the ``E`` logical experts owns between 1 and ``max_replicas``
physical weight slots, out of ``n_ranks * slots_per_rank`` statically
shaped slots (``slots_per_rank >= E // n_ranks``; the excess is the spare
capacity replicas live in).  ``rep_pos[e, j]`` is the physical slot
(``rank * slots_per_rank + slot``) of replica ``j`` of expert ``e``;
entries at ``j >= n_rep[e]`` repeat the primary so traced gathers never
read garbage.  ``slot_owner`` is the inverse view: the logical expert
resident in each physical slot, ``-1`` for an empty spare.

With ``slots_per_rank == E // n_ranks`` and ``max_replicas == 1`` a
ReplicaSet *is* a PlacementTable (the identity configuration the bitwise
regression tests pin), so the whole placement machinery — weight-slab
gathers, checkpointing, the traced MoE table — degrades gracefully to
the bijective behavior.

Replicas of one expert always live on distinct ranks: splitting a
logical expert's tokens between two slots of the *same* rank changes
nothing about that rank's load, so such sets are rejected as planner
bugs rather than silently accepted.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.placement.table import PlacementTable


@dataclasses.dataclass(frozen=True)
class ReplicaSet:
    rep_pos: np.ndarray        # [E, R] int32: physical slot per replica
    n_rep: np.ndarray          # [E] int32: valid replicas per expert (>= 1)
    n_ranks: int
    slots_per_rank: int

    def __post_init__(self):
        rp = np.asarray(self.rep_pos, np.int32)
        nr = np.asarray(self.n_rep, np.int32)
        if rp.ndim != 2:
            raise ValueError(f"rep_pos must be [E, R], got {rp.shape}")
        object.__setattr__(self, "rep_pos", rp)
        object.__setattr__(self, "n_rep", nr)
        e, r = rp.shape
        if nr.shape != (e,):
            raise ValueError((rp.shape, nr.shape))
        if not ((1 <= nr) & (nr <= r)).all():
            raise ValueError(f"n_rep out of [1, {r}]: {nr}")
        s = self.n_slots
        if e > s:
            raise ValueError(f"{e} experts need at least {e} slots, got {s}")
        if not ((0 <= rp) & (rp < s)).all():
            raise ValueError("rep_pos out of range")
        valid = self._valid_mask()
        # padding entries must repeat the primary (traced round-robin
        # gathers index the full row; mod n_rep keeps them unselected, but
        # a well-formed pad makes the table self-describing)
        if not (np.where(valid, rp, rp[:, :1]) == rp).all():
            raise ValueError("pad entries must repeat rep_pos[:, 0]")
        flat = rp[valid]
        if len(np.unique(flat)) != flat.shape[0]:
            raise ValueError("replica slots are not distinct")
        ranks = rp // self.slots_per_rank
        for ex in range(e):
            rr = ranks[ex, : nr[ex]]
            if len(np.unique(rr)) != rr.shape[0]:
                raise ValueError(
                    f"expert {ex} has two replicas on one rank: {rr}")

    # -- derived views ----------------------------------------------------
    def _valid_mask(self) -> np.ndarray:
        """[E, R] bool: which rep_pos entries are live replicas (the rest
        are primary-repeating padding)."""
        cols = np.arange(self.rep_pos.shape[1])[None, :]
        return cols < self.n_rep[:, None]

    def _per_replica(self, row_values: np.ndarray) -> np.ndarray:
        """Broadcast a per-expert row vector over the [E, R] replica
        matrix (padding entries included; mask with _valid_mask)."""
        return np.broadcast_to(row_values[:, None], self.rep_pos.shape)

    @property
    def num_experts(self) -> int:
        return int(self.rep_pos.shape[0])

    @property
    def max_replicas(self) -> int:
        return int(self.rep_pos.shape[1])

    @property
    def n_slots(self) -> int:
        return self.n_ranks * self.slots_per_rank

    @property
    def n_spare(self) -> int:
        """Physical slots not holding any replica."""
        return self.n_slots - int(self.n_rep.sum())

    @property
    def is_bijective(self) -> bool:
        return (self.n_slots == self.num_experts
                and int(self.n_rep.max()) == 1)

    @property
    def slot_owner(self) -> np.ndarray:
        """[S] physical slot -> resident logical expert (-1 = empty)."""
        own = np.full(self.n_slots, -1, np.int32)
        valid = self._valid_mask()
        e_ids = self._per_replica(np.arange(self.num_experts,
                                            dtype=np.int32))
        own[self.rep_pos[valid]] = e_ids[valid]
        return own

    @property
    def rep_rank(self) -> np.ndarray:
        """[E, R] owning rank per replica (pad entries repeat the primary)."""
        return self.rep_pos // self.slots_per_rank

    def rank_loads(self, expert_load: np.ndarray,
                   weights: np.ndarray = None) -> np.ndarray:
        """Post-split per-rank loads [n_ranks]: each expert's load split
        over its replicas — equally (the round-robin dispatch rule) or by
        ``weights`` [E, R] (the weighted-split dispatch rule; rows are
        normalized over the valid replicas)."""
        load = np.asarray(expert_load, np.float64)
        valid = self._valid_mask()
        if weights is None:
            share = self._per_replica(load / np.maximum(self.n_rep, 1))
        else:
            w = np.where(valid, np.asarray(weights, np.float64), 0.0)
            tot = np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
            share = load[:, None] * (w / tot)
        out = np.zeros(self.n_ranks, np.float64)
        np.add.at(out, self.rep_rank[valid], share[valid])
        return out

    def capacity_factor(self, expert_load: np.ndarray,
                        margin: float = 1.25,
                        floor: float = 1.0,
                        rank_alive: np.ndarray = None) -> float:
        """Dispatch ``capacity_factor`` sized from the *post-split*
        worst-case rank load instead of the bijective worst case.

        The per-rank dispatch buffer holds ``t*k/ep × capacity_factor``
        entries, so the factor must cover the peak rank's share of the
        routed load.  Under replication the hot experts are split across
        replicas, so the post-split peak (``rank_loads(load).max()`` over
        the equal-split model) is flatter than the bijective peak — the
        buffer (and its HBM) can shrink by the same ratio.  ``margin``
        is the safety headroom over the predicted peak; ``floor`` the
        minimum factor (1.0 = perfectly balanced provisioning).

        ``rank_alive`` [n_ranks] restricts the peak/ideal computation to
        live ranks (degraded mode: dead ranks serve no tokens, so the
        surviving ranks' buffers must absorb the redistributed load).
        """
        rl = self.rank_loads(expert_load)
        if rank_alive is not None:
            rl = rl[np.asarray(rank_alive, bool)]
        n = max(rl.shape[0], 1)
        tot = rl.sum()
        if tot <= 0:
            return float(floor)
        ib = rl.max() / (tot / n)              # post-split peak / ideal
        return float(max(floor, margin * ib))

    def slot_loads(self, expert_load: np.ndarray) -> np.ndarray:
        """Post-split per-physical-slot loads [S] (empty slots 0)."""
        load = np.asarray(expert_load, np.float64)
        share = self._per_replica(load / np.maximum(self.n_rep, 1))
        valid = self._valid_mask()
        out = np.zeros(self.n_slots, np.float64)
        np.add.at(out, self.rep_pos[valid], share[valid])
        return out

    def as_arrays(self):
        """(rep_pos [E,R], n_rep [E], slot_owner [S]) for the traced MoE
        layer (:class:`repro_torch.core.ep_moe.Replication`)."""
        return self.rep_pos, self.n_rep, self.slot_owner

    # -- elastic views ----------------------------------------------------
    def masked(self, rank_alive: np.ndarray):
        """Mask dead ranks out of the set: ``(masked_set, lost_experts)``.

        Per expert, replicas on dead ranks are dropped and the row is
        re-padded from the first surviving replica — a table flip with no
        data motion, because surviving slabs are already resident (the
        distinct-rank planner invariant is what guarantees a candidate).
        An expert with *no* surviving replica keeps its original row (it
        still points at the dead slot, whose slab is gone) and is reported
        in ``lost_experts``; its tokens are unroutable until the expert is
        re-materialized from checkpoint.
        """
        alive = np.asarray(rank_alive, bool)
        if alive.shape != (self.n_ranks,):
            raise ValueError((alive.shape, self.n_ranks))
        rp = self.rep_pos.copy()
        nr = self.n_rep.copy()
        lost = []
        for ex in range(self.num_experts):
            n = int(self.n_rep[ex])
            live = [j for j in range(n) if alive[self.rep_rank[ex, j]]]
            if not live:
                lost.append(ex)
                continue
            row = [self.rep_pos[ex, j] for j in live]
            rp[ex] = row + [row[0]] * (self.max_replicas - len(row))
            nr[ex] = len(live)
        return (ReplicaSet(rp, nr, self.n_ranks, self.slots_per_rank),
                np.asarray(lost, np.int64))

    def hosts_rank(self, rank: int) -> bool:
        """Does any live replica reside on ``rank``?"""
        return bool((self.rep_rank[self._valid_mask()] == rank).any())

    # -- weighted token splitting -----------------------------------------
    SPLIT_QUANTUM = 12             # schedule length Q (lcm of 1..4, 6)

    def split_schedule(self, weights: np.ndarray = None) -> np.ndarray:
        """[E, Q] int32 replica-index schedule for weighted token
        splitting
        (:class:`repro_torch.core.ep_moe.WeightedReplication.split_sched`).

        The traced dispatch sends the ``occ``-th routed token of expert
        ``e`` to replica ``sched[e, occ % Q]``.  With ``weights`` the
        schedule is built by deficit round-robin — per phase slot each
        replica accrues credit proportional to its normalized weight and
        the highest-credit replica (lowest index on ties) is picked — so
        token shares match the weights to quantization ±1/Q *interleaved*,
        not block-wise: shard-local occurrence counters stay within ±1 of
        the global split, the same property the equal round-robin has.
        With equal weights the schedule is exactly ``m % n_rep`` — when
        ``n_rep`` divides Q this is bitwise-identical to the unscheduled
        ``occ % n_rep`` path.
        """
        e, r = self.rep_pos.shape
        q = self.SPLIT_QUANTUM
        base = (np.arange(q)[None, :]
                % np.maximum(self.n_rep, 1)[:, None]).astype(np.int32)
        if weights is None:
            return base
        w = np.where(self._valid_mask(),
                     np.asarray(weights, np.float64), 0.0)
        sched = base.copy()
        for ex in range(e):
            n = int(self.n_rep[ex])
            ww = w[ex, :n]
            if n <= 1 or ww.sum() <= 0:
                continue
            ww = ww / ww.sum()
            credit = np.zeros(n)
            for m in range(q):
                credit += ww
                j = int(np.argmax(credit))   # argmax ties -> lowest index
                sched[ex, m] = j
                credit[j] -= 1.0
        return sched

    def residual_split_weights(self, expert_load: np.ndarray,
                               rank_alive: np.ndarray = None,
                               floor: float = 1e-3) -> np.ndarray:
        """[E, R] split weights proportional to host-rank *residual*
        capacity: a replica whose rank is already loaded (by the other
        experts it hosts) takes a smaller share of its expert's tokens.

        Residual of replica ``j`` = ``max(target - other_load_j, floor)``
        where ``target`` is the mean live-rank load and ``other_load_j``
        is the host rank's equal-split load minus this expert's own share
        (so an expert doesn't see its own traffic as congestion).
        Replicas on dead ranks get weight 0 (degraded mode).
        """
        load = np.asarray(expert_load, np.float64)
        rl = self.rank_loads(load)
        alive = (np.ones(self.n_ranks, bool) if rank_alive is None
                 else np.asarray(rank_alive, bool))
        n_live = max(int(alive.sum()), 1)
        target = rl[alive].sum() / n_live
        eps = floor * max(target, 1.0)
        w = np.zeros(self.rep_pos.shape)
        w[:, 0] = 1.0
        share = load / np.maximum(self.n_rep, 1)
        for ex in np.flatnonzero(self.n_rep > 1):
            n = int(self.n_rep[ex])
            ranks = self.rep_rank[ex, :n]
            other = rl[ranks] - share[ex]
            resid = np.maximum(target - other, eps)
            resid[~alive[ranks]] = 0.0
            if resid.sum() <= 0:           # every replica on a dead rank
                resid[:] = 1.0
            w[ex, :n] = resid
            w[ex, n:] = 0.0
        return w

    # -- constructors -----------------------------------------------------
    @classmethod
    def identity(cls, num_experts: int, n_ranks: int,
                 slots_per_rank: int = 0,
                 max_replicas: int = 1) -> "ReplicaSet":
        """Contiguous single-replica layout: expert ``e`` in slot
        ``(e // e_loc) * slots_per_rank + e % e_loc`` — with
        ``slots_per_rank == e_loc`` this is the identity placement."""
        return cls.from_placement(
            PlacementTable.identity(num_experts, n_ranks),
            slots_per_rank=slots_per_rank, max_replicas=max_replicas)

    @classmethod
    def from_placement(cls, table: PlacementTable,
                       slots_per_rank: int = 0,
                       max_replicas: int = 1) -> "ReplicaSet":
        """Lift a bijective table into a (possibly spare-padded) set."""
        e_loc = table.e_loc
        s_loc = slots_per_rank or e_loc
        assert s_loc >= e_loc, (s_loc, e_loc)
        pos = (table.e2r.astype(np.int64) * s_loc
               + table.local_slot.astype(np.int64))
        rep_pos = np.broadcast_to(
            pos[:, None], (table.num_experts, max_replicas)).astype(np.int32)
        return cls(rep_pos.copy(), np.ones(table.num_experts, np.int32),
                   table.n_ranks, s_loc)

    def ownership_matrix(self) -> np.ndarray:
        """[E, n_ranks] fractional ownership (rows sum to 1) — the cost
        model's replication view (``benchmarks/traces.rank_loads``)."""
        mat = np.zeros((self.num_experts, self.n_ranks))
        valid = self._valid_mask()
        frac = self._per_replica(1.0 / np.maximum(self.n_rep, 1))
        e_ids = self._per_replica(np.arange(self.num_experts))
        np.add.at(mat, (e_ids[valid], self.rep_rank[valid]), frac[valid])
        return mat

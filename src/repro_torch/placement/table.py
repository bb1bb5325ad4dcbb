"""Expert→rank placement tables (host side).

A :class:`PlacementTable` is the host-numpy twin of the traced
``repro_torch.core.ep_moe.Placement`` tuple: ``e2r[e]`` names the EP rank that
owns logical expert ``e`` and ``local_slot[e]`` its position in that
rank's fixed-size weight slab.  Together they are a bijection onto
``rank * e_loc + slot`` — slabs hold exactly ``E // n_ranks`` experts
because the physical buffers (and the capacity-packed dispatch layout)
are statically shaped.

The *placed position* ``pos[e] = e2r[e] * e_loc + local_slot[e]`` is the
row at which expert ``e``'s weights live in the (physically permuted)
``[E, ...]`` weight arrays; ``owner`` is the inverse permutation
(physical row → logical expert).  Migration between two tables is a
gather of weight rows by ``owner`` composition — see
:mod:`repro_torch.placement.migrate`.

A table is the single-replica special case of the redundant-expert
ownership matrix: :meth:`repro_torch.replication.ReplicaSet.from_placement`
lifts one into a (possibly spare-padded) replica set, and the identity
replica set round-trips back to this exact layout.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PlacementTable:
    e2r: np.ndarray            # [E] int32: logical expert -> owning rank
    local_slot: np.ndarray     # [E] int32: slot within the owner's slab
    n_ranks: int

    def __post_init__(self):
        e2r = np.asarray(self.e2r, np.int32)
        ls = np.asarray(self.local_slot, np.int32)
        object.__setattr__(self, "e2r", e2r)
        object.__setattr__(self, "local_slot", ls)
        e = e2r.shape[0]
        assert ls.shape == (e,), (e2r.shape, ls.shape)
        assert e % self.n_ranks == 0, (e, self.n_ranks)
        e_loc = e // self.n_ranks
        counts = np.bincount(e2r, minlength=self.n_ranks)
        assert counts.shape[0] == self.n_ranks and (counts == e_loc).all(), \
            f"each rank must own exactly {e_loc} experts, got {counts}"
        pos = self.pos
        assert len(np.unique(pos)) == e, "e2r/local_slot is not a bijection"

    # -- derived views ----------------------------------------------------
    @property
    def num_experts(self) -> int:
        return int(self.e2r.shape[0])

    @property
    def e_loc(self) -> int:
        return self.num_experts // self.n_ranks

    @property
    def pos(self) -> np.ndarray:
        """[E] logical expert -> physical weight row (placed position)."""
        return self.e2r.astype(np.int64) * self.e_loc \
            + self.local_slot.astype(np.int64)

    @property
    def owner(self) -> np.ndarray:
        """[E] physical weight row -> logical expert (inverse of pos)."""
        inv = np.empty(self.num_experts, np.int64)
        inv[self.pos] = np.arange(self.num_experts)
        return inv

    def rank_loads(self, expert_load: np.ndarray) -> np.ndarray:
        """Aggregate per-logical-expert loads onto the placed ranks [R]."""
        out = np.zeros(self.n_ranks, np.float64)
        np.add.at(out, self.e2r, np.asarray(expert_load, np.float64))
        return out

    def as_tuple(self) -> Tuple[np.ndarray, np.ndarray]:
        """(e2r, local_slot) for the MoE layer."""
        return self.e2r, self.local_slot

    # -- constructors -----------------------------------------------------
    @classmethod
    def identity(cls, num_experts: int, n_ranks: int) -> "PlacementTable":
        ar = np.arange(num_experts, dtype=np.int32)
        e_loc = num_experts // n_ranks
        return cls(ar // e_loc, ar % e_loc, n_ranks)

    @classmethod
    def from_ranks(cls, e2r: np.ndarray, n_ranks: int) -> "PlacementTable":
        """Derive slots from a rank assignment: experts keep logical order
        within their rank (stable), so repeated planning is deterministic."""
        e2r = np.asarray(e2r, np.int32)
        slot = np.zeros_like(e2r)
        for r in range(n_ranks):
            members = np.flatnonzero(e2r == r)
            slot[members] = np.arange(members.shape[0])
        return cls(e2r, slot, n_ranks)

"""Live replica add/drop: ReplicaSet diff → physical-slot weight gather.

Same mechanism as bijective placement migration
(:mod:`repro_torch.placement.migrate`): the expert weight arrays are stored in
physical-slot order ``[S, ...]``, and a new set is applied by one gather
along the slot axis — ``w_new[..., p, :] = w_old[..., gather_idx[p], :]``.
The produced :class:`ReplicaMigrationPlan` is interface-compatible with
:class:`~repro_torch.placement.migrate.MigrationPlan` (``gather_idx`` /
``is_noop`` / ``n_moved``), so ``placement.migrate.apply_to_params``
applies it unchanged.

Source selection per changed slot: prefer an old replica of the incoming
expert that already lives on the *destination* slot's rank (an HBM-local
copy, zero cross-rank bytes), else the old primary (a cross-rank slab
transfer, charged ``bytes_per_expert``).  Retiring a replica is free —
the slot merely stops being routable (its stale weights are unreachable:
no ``rep_pos`` entry points at it).

Consistency rule: a replica is routable only after its slab lands.  The
plan carries the *pending* set; :class:`~repro_torch.replication.manager.
ReplicaManager` keeps serving the old set until ``commit(plan)`` — which
the engine calls only after ``apply_to_params`` has produced the permuted
weights — flips the routable table.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.placement.migrate import MOE_WEIGHT_KEYS, moe_param_paths
from repro_torch.placement.migrate import apply_layers_to_params as \
    _apply_layers_to_params
from repro_torch.replication.replica_set import ReplicaSet


@dataclasses.dataclass(frozen=True)
class ReplicaMigrationPlan:
    gather_idx: np.ndarray     # [S] new physical slot -> old physical slot
    changed_slots: np.ndarray  # slots whose resident expert changed
    crossrank_slots: np.ndarray  # changed slots sourced from another rank
    moved_bytes: int           # cross-rank weight bytes of the transition
    new_set: "ReplicaSet"      # the pending (not yet routable) set

    @property
    def n_moved(self) -> int:
        return int(self.changed_slots.shape[0])

    @property
    def is_noop(self) -> bool:
        return self.n_moved == 0


@dataclasses.dataclass(frozen=True)
class LayerReplicaMigrationPlan:
    """Layer-diff replica transition across per-layer replica sets.

    Same staged-commit semantics as :class:`ReplicaMigrationPlan` (the
    pending ``new_sets`` become routable only on ``commit``), but each
    scanned block's slot slab is gathered by its own ``gather_idx`` row;
    unchanged layers carry the identity row and cost nothing."""
    gather_idx: np.ndarray        # [L, S] per-layer new slot -> old slot
    changed_per_layer: np.ndarray  # [L] slots whose resident changed
    crossrank_per_layer: np.ndarray  # [L] changed slots crossing ranks
    moved_bytes: int              # cross-rank bytes, changed layers only
    new_sets: tuple               # the pending per-layer ReplicaSets

    @property
    def n_layers(self) -> int:
        return int(self.gather_idx.shape[0])

    @property
    def changed_layers(self) -> np.ndarray:
        return np.flatnonzero(self.changed_per_layer)

    @property
    def n_moved(self) -> int:
        """Total (slot, layer) pairs whose resident expert changed."""
        return int(self.changed_per_layer.sum())

    @property
    def n_crossrank(self) -> int:
        return int(self.crossrank_per_layer.sum())

    @property
    def is_noop(self) -> bool:
        return self.n_moved == 0


def diff(old: ReplicaSet, new: ReplicaSet,
         bytes_per_expert: int = 0) -> ReplicaMigrationPlan:
    """The slot gather (and cost) taking placed weights from old to new."""
    assert old.num_experts == new.num_experts, (old, new)
    assert old.n_ranks == new.n_ranks, (old.n_ranks, new.n_ranks)
    assert old.slots_per_rank == new.slots_per_rank, \
        (old.slots_per_rank, new.slots_per_rank)
    s = old.n_slots
    own_old, own_new = old.slot_owner, new.slot_owner
    gather = np.arange(s, dtype=np.int64)
    changed, cross = [], []
    for p in range(s):
        ex = own_new[p]
        if ex == own_old[p]:
            continue
        if ex < 0:
            # retired slot: content is unreachable, keep it in place
            continue
        changed.append(p)
        srcs = old.rep_pos[ex, : old.n_rep[ex]]
        same_rank = srcs[srcs // old.slots_per_rank
                         == p // new.slots_per_rank]
        if same_rank.shape[0]:
            gather[p] = int(same_rank[0])          # HBM-local copy
        else:
            gather[p] = int(srcs[0])               # cross-rank transfer
            cross.append(p)
    changed = np.asarray(changed, np.int64)
    cross = np.asarray(cross, np.int64)
    return ReplicaMigrationPlan(
        gather_idx=gather, changed_slots=changed, crossrank_slots=cross,
        moved_bytes=int(cross.shape[0]) * bytes_per_expert, new_set=new)


def diff_layers(old_sets, new_sets,
                bytes_per_expert: int = 0) -> LayerReplicaMigrationPlan:
    """Layer-diff between two per-layer replica-set stacks.

    ``bytes_per_expert`` is the slab bytes of one expert in ONE scanned
    block; only cross-rank (slot, layer) sources are charged."""
    assert len(old_sets) == len(new_sets), (len(old_sets), len(new_sets))
    gather, changed, cross = [], [], []
    for old, new in zip(old_sets, new_sets):
        p = diff(old, new)
        gather.append(p.gather_idx)
        changed.append(p.n_moved)
        cross.append(int(p.crossrank_slots.shape[0]))
    cross = np.asarray(cross, np.int64)
    return LayerReplicaMigrationPlan(
        gather_idx=np.stack(gather).astype(np.int64),
        changed_per_layer=np.asarray(changed, np.int64),
        crossrank_per_layer=cross,
        moved_bytes=int(cross.sum()) * bytes_per_expert,
        new_sets=tuple(new_sets))


def apply_layers_to_params(params: Dict[str, Any], plan, layers,
                           landed=None) -> Dict[str, Any]:
    """Chunked subset apply of a replica plan: gather only ``layers``'
    slot slabs (identity rows elsewhere).  Replica ``gather_idx``
    semantics are identical to placement's (new slot <- old slot), so
    this delegates to :func:`repro_torch.placement.migrate.
    apply_layers_to_params`; a shared :class:`ReplicaMigrationPlan` is
    one chunk (layer 0 = the whole plan)."""
    return _apply_layers_to_params(params, plan, layers, landed)


def expand_moe_params(params: Dict[str, Any], rset) -> Dict[str, Any]:
    """Lay logically-ordered ``[.., E, ..]`` expert weights out into the
    set's physical ``[.., S, ..]`` slot order (empty spares zeroed), in
    ``params`` itself, and return it.

    The inverse of the identity assumption: a freshly initialised /
    restored model stores one row per logical expert; a replica engine
    stores one row per physical slot.  Routers stay logical and are not
    touched.  Works on stacked ``[n_blocks, E, ...]`` weights and on
    unstacked ``[E, ...]`` ones.  Empty spares are zeroed by multiplying
    with the slot mask, as the reference does (a negative weight becomes
    -0.0, a NaN stays NaN).

    ``rset`` is a single :class:`ReplicaSet` (shared across layers) or a
    sequence of per-layer sets — the latter requires stacked
    ``[n_blocks, E, ...]`` weights and expands each block by its own
    layer's slot layout.

    One weight tensor at a time: its ``[.., S, ..]`` successor is
    allocated and filled block by block, then replaces it, so the peak
    holds one tensor twice, never the whole expert stack.
    """
    rsets = list(rset) if isinstance(rset, (list, tuple)) else None
    if rsets is not None and len(rsets) == 1:
        rset, rsets = rsets[0], None
    if rsets is not None:
        owner = np.stack([rs.slot_owner for rs in rsets])        # [L, S]
        n_e = rsets[0].num_experts
    else:
        owner = rset.slot_owner[None]                             # [1, S]
        n_e = rset.num_experts
    idx = np.where(owner >= 0, owner, 0).astype(np.int64)
    keep = owner >= 0
    for group, lname in moe_param_paths(params):
        moe = params[group][lname]["moe"]
        for key in MOE_WEIGHT_KEYS:
            w = moe[key]
            stacked = w.dim() == 4
            if rsets is not None:
                assert stacked and w.shape[0] == len(rsets) \
                    and w.shape[1] == n_e, (key, w.shape, len(rsets), n_e)
            assert w.shape[-3] == n_e, (key, w.shape, n_e)
            blocks = [w[b] for b in range(w.shape[0])] if stacked else [w]
            out = torch.empty(w.shape[:-3] + (idx.shape[1],) + w.shape[-2:],
                              dtype=w.dtype, device=w.device)
            outs = [out[b] for b in range(out.shape[0])] if stacked \
                else [out]
            for b, (src, dst) in enumerate(zip(blocks, outs)):
                row = 0 if idx.shape[0] == 1 else b
                torch.index_select(src, 0, torch.as_tensor(
                    idx[row], device=w.device), out=dst)
                if not keep[row].all():
                    dst.mul_(torch.as_tensor(keep[row], dtype=w.dtype,
                                             device=w.device)[:, None, None])
            moe[key] = out
            del w, blocks, src, dst    # the [.., E, ..] tensor can go
    return params

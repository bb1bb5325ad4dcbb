"""Live migration: plan-diff → expert-slab permutation of the weights.

The expert weight arrays are stored in *placed* (physical) order.  A new
plan is applied by one gather along the expert axis:

    w_new[..., p, :] = w_old[..., gather_idx[p], :]
    gather_idx = old.pos[new.owner]

i.e. physical row ``p`` must now hold logical expert ``new.owner[p]``,
whose weights currently sit at row ``old.pos[expert]``.  On one device
the gather is a copy, made *in place* on the weights' own device, one
(block, weight) slab at a time and only over the rows that change: a
second copy of the expert stack would not fit beside the first at full
width.  Only the routed expert tensors move — router weights are indexed
by *logical* expert id and never migrate, and attention / shared-expert / M-state
tensors are untouched.

``MigrationPlan`` also carries the accounting the benchmarks need: which
experts physically moved rank, and how many bytes of weights that is —
plus the *pending* new table(s), so managers can stage a plan (old table
stays routable) and commit per layer as each slab lands
(:mod:`repro_torch.serving.async_migrate`).  An in-place gather that fails
part-way reports the blocks that landed (``landed``), so the caller can
commit exactly those layers or gather them back (``diff`` of the new
table against the old one is the inverse gather).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MIGRATION_BW_DEFAULT, ModelConfig
from repro_torch.placement.table import PlacementTable

MOE_WEIGHT_KEYS = ("w_gate", "w_up", "w_down")


class MigrationBandwidth:
    """Measured slab-transfer bandwidth: an EWMA of observed
    ``apply_to_params`` bytes/s, seeded with a nominal prior.

    One instance is shared by everything that prices migration bytes —
    the manager's ``migration_seconds`` (virtual-clock charge), the async
    executor's per-iteration chunk budget, and the replan cost gates
    (``benchmarks.costmodel.ReplanCostGate.bandwidth``) — so a measured
    value replaces the static nominal constant *everywhere at once*
    (ROADMAP "migration-bandwidth calibration").  ``float(bw)`` reads the
    current bytes/s.
    """

    def __init__(self, init_bw: float = MIGRATION_BW_DEFAULT,
                 alpha: float = 0.25):
        self.init_bw = float(init_bw)
        self.alpha = float(alpha)
        self._bw = float(init_bw)
        self.n_obs = 0

    def observe(self, nbytes: int, seconds: float) -> None:
        """One timed slab transfer (wall clock of the apply)."""
        if nbytes <= 0 or seconds <= 0:
            return
        sample = float(nbytes) / float(seconds)
        # first measurement replaces the prior outright: a nominal link
        # constant should not anchor a host whose fabric is 1000x off
        self._bw = sample if self.n_obs == 0 \
            else (1.0 - self.alpha) * self._bw + self.alpha * sample
        self.n_obs += 1

    @property
    def bytes_per_s(self) -> float:
        return self._bw

    @property
    def calibrated(self) -> bool:
        return self.n_obs > 0

    def __float__(self) -> float:
        return self._bw

    def seconds(self, nbytes: int) -> float:
        """Transfer time of ``nbytes`` at the current estimate."""
        return float(nbytes) / max(self._bw, 1.0)

    def reset(self) -> None:
        self._bw = self.init_bw
        self.n_obs = 0


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    gather_idx: np.ndarray     # [E] new physical row -> old physical row
    moved_experts: np.ndarray  # logical expert ids whose rank changed
    moved_bytes: int           # total weight bytes crossing ranks
    new_table: Optional[PlacementTable] = None  # pending (staged) table

    @property
    def n_moved(self) -> int:
        return int(self.moved_experts.shape[0])

    @property
    def is_noop(self) -> bool:
        return self.n_moved == 0


@dataclasses.dataclass(frozen=True)
class LayerMigrationPlan:
    """Layer-diff migration across per-layer placement tables.

    ``gather_idx [L, E]`` permutes each scanned block's weight slab
    independently; unchanged layers carry the identity row, so migration
    traffic scales with the number of *changed* layers rather than
    ``n_layers×`` (HarMoEny-style layer-wise rebalancing).
    ``moved_per_layer [L]`` counts experts whose rank changed in each
    layer; ``moved_bytes`` charges only those (expert, layer) pairs."""
    gather_idx: np.ndarray      # [L, E] per-layer new row -> old row
    moved_per_layer: np.ndarray  # [L] experts that changed rank per layer
    moved_bytes: int            # cross-rank bytes, changed layers only
    new_tables: tuple = ()      # pending (staged) per-layer tables

    @property
    def n_layers(self) -> int:
        return int(self.gather_idx.shape[0])

    @property
    def changed_layers(self) -> np.ndarray:
        return np.flatnonzero(self.moved_per_layer)

    @property
    def n_moved(self) -> int:
        """Total (expert, layer) pairs that changed rank."""
        return int(self.moved_per_layer.sum())

    @property
    def is_noop(self) -> bool:
        return self.n_moved == 0


def expert_bytes_raw(d_model: int, d_ff: int, bytes_per_param: float,
                     n_moe_layers: int) -> float:
    """Weight bytes of ONE expert (gate+up+down) across the MoE stack —
    the single formula shared by the serving manager and the analytic
    cost model."""
    return 3.0 * d_model * d_ff * bytes_per_param * n_moe_layers


def expert_bytes(cfg: ModelConfig, n_moe_layers: int) -> int:
    """Weight bytes of ONE expert across the whole MoE stack."""
    itemsize = np.dtype(cfg.param_dtype).itemsize \
        if cfg.param_dtype != "bfloat16" else 2
    return int(expert_bytes_raw(cfg.d_model, cfg.moe.d_ff, itemsize,
                                n_moe_layers))


def diff(old: PlacementTable, new: PlacementTable,
         bytes_per_expert: int = 0) -> MigrationPlan:
    """The permutation (and cost) taking placed weights from old to new."""
    assert old.num_experts == new.num_experts, (old, new)
    assert old.n_ranks == new.n_ranks, (old.n_ranks, new.n_ranks)
    gather = old.pos[new.owner]
    moved = np.flatnonzero(old.e2r != new.e2r)
    return MigrationPlan(gather_idx=gather.astype(np.int64),
                         moved_experts=moved,
                         moved_bytes=int(moved.shape[0]) * bytes_per_expert,
                         new_table=new)


def diff_layers(old_tables, new_tables,
                bytes_per_expert: int = 0) -> LayerMigrationPlan:
    """Layer-diff between two per-layer table stacks.

    ``bytes_per_expert`` is the weight bytes of one expert in ONE scanned
    block (not the whole stack): only (expert, layer) pairs whose rank
    changed are charged."""
    assert len(old_tables) == len(new_tables), \
        (len(old_tables), len(new_tables))
    gather, moved = [], []
    for old, new in zip(old_tables, new_tables):
        p = diff(old, new)
        gather.append(p.gather_idx)
        moved.append(p.n_moved)
    moved = np.asarray(moved, np.int64)
    return LayerMigrationPlan(
        gather_idx=np.stack(gather).astype(np.int64),
        moved_per_layer=moved,
        moved_bytes=int(moved.sum()) * bytes_per_expert,
        new_tables=tuple(new_tables))


def moe_param_paths(params: Dict[str, Any]) -> List[Tuple[str, str]]:
    """(block_group, layer_key) pairs holding routed-expert weights."""
    out = []
    for group in ("blocks", "prefix"):
        sub = params.get(group)
        if not isinstance(sub, dict):
            continue
        for lname, lp in sub.items():
            if isinstance(lp, dict) and "moe" in lp:
                out.append((group, lname))
    return out


def apply_to_params(params: Dict[str, Any], plan,
                    landed: Optional[List] = None) -> Dict[str, Any]:
    """Gather every routed-expert weight slab by the migration plan, in
    place, and return ``params`` (the same tree).

    Works on stacked ``[n_blocks, E, ...]`` weights and on unstacked
    ``[E, ...]`` ones; the router is left in logical order.  ``plan`` is
    anything exposing ``gather_idx`` / ``is_noop``: a bijective
    :class:`MigrationPlan` (``[E]`` permutation), a
    :class:`repro_torch.replication.migrate.ReplicaMigrationPlan` (``[S]``
    slot gather), or a per-layer :class:`LayerMigrationPlan` /
    ``LayerReplicaMigrationPlan`` (``[L, E|S]``: each stacked block's slab
    gathered by its own layer's row).

    The unit of work is one block (all of its weight keys): each block's
    gathered rows are read into temporaries before any is written, so a
    failure leaves every block either untouched or fully gathered.  Each
    block whose slabs were rewritten is appended to ``landed`` as
    ``(group, layer_key, block)`` (``block`` None for an unstacked
    layer); a block whose row is the identity is left alone."""
    if plan.is_noop:
        return params
    idx = np.asarray(plan.gather_idx, np.int64)
    for group, lname in moe_param_paths(params):
        moe = params[group][lname]["moe"]
        ws = [moe[key] for key in MOE_WEIGHT_KEYS]
        if ws[0].dim() == 3:               # unstacked layer [E|S, a, b]
            assert idx.ndim == 1 or idx.shape[0] == 1, \
                (idx.shape, ws[0].shape, "per-layer plan needs stacked "
                 "[n_blocks, ...] weights")
            if _gather_rows(ws, idx.reshape(-1)) and landed is not None:
                landed.append((group, lname, None))
            continue
        assert idx.ndim == 1 or idx.shape[0] == ws[0].shape[0], \
            (ws[0].shape, idx.shape)
        for b in range(ws[0].shape[0]):
            row = idx if idx.ndim == 1 else idx[b]
            if _gather_rows([w[b] for w in ws], row) and landed is not None:
                landed.append((group, lname, b))
    return params


def undo_blocks(params: Dict[str, Any], plan, units) -> Dict[str, Any]:
    """Gather the blocks ``units`` (as ``apply_to_params`` reports them)
    by ``plan``, in place: with the diff of the new table against the old
    one, this takes landed blocks of a failed apply back to the old
    layout (every routable slot regains its old expert)."""
    idx = np.asarray(plan.gather_idx, np.int64)
    for group, lname, b in units:
        moe = params[group][lname]["moe"]
        ws = [moe[key] if b is None else moe[key][b]
              for key in MOE_WEIGHT_KEYS]
        row = idx if idx.ndim == 1 else idx[0 if b is None else b]
        _gather_rows(ws, row)
    return params


def roll_back(err: BaseException, params: Dict[str, Any], undo, landed,
              abort) -> None:
    """Clean up after an apply that raised ``err``: ``abort`` the staged
    plan first, so the old tables stay the routable ones whatever follows,
    then gather the ``landed`` blocks back by ``undo`` (see
    ``undo_blocks``).  A failure of that gather is noted on ``err`` rather
    than raised in its place; the caller re-raises ``err``."""
    abort()
    if not landed or undo is None:
        return
    try:
        undo_blocks(params, undo, landed)
    except BaseException as undo_err:
        err.add_note(f"gathering the {len(landed)} landed block(s) back "
                     f"also failed ({undo_err!r}): their slabs do not match "
                     "the routable tables")


def _gather_rows(slabs: List[torch.Tensor], row: np.ndarray) -> bool:
    """``slab[p] = slab[row[p]]`` for every slab of one block, over the
    rows that change only; the source rows of all slabs are read before
    any is written.  The indices go up once per block, between forwards.
    Returns whether any row changed."""
    changed = np.flatnonzero(row != np.arange(row.shape[0]))
    if changed.size == 0:
        return False
    dev = slabs[0].device
    dst = torch.as_tensor(changed, dtype=torch.long, device=dev)
    src = torch.as_tensor(row[changed], dtype=torch.long, device=dev)
    rows = [w.index_select(0, src) for w in slabs]
    for w, r in zip(slabs, rows):
        w.index_copy_(0, dst, r)
    return True


@dataclasses.dataclass(frozen=True)
class _LayerSubsetPlan:
    """A plan-shaped view gathering only a subset of a layer plan's rows
    (identity rows everywhere else) — what ``apply_to_params`` needs."""
    gather_idx: np.ndarray
    is_noop: bool = False


def subset_plan(plan, layers: Sequence[int]):
    """The plan restricted to ``layers``: selected layers keep their
    gather rows, every other layer gets the identity row.

    For a *shared* (1-D) plan the only meaningful subset is the whole
    plan — layer index 0 stands for "the one shared chunk"."""
    idx = np.asarray(plan.gather_idx)
    sel = sorted({int(l) for l in layers})
    if idx.ndim == 1:
        assert sel == [0], \
            (sel, "a shared plan has exactly one chunk (layer 0)")
        return plan
    assert all(0 <= l < idx.shape[0] for l in sel), (sel, idx.shape)
    full = np.tile(np.arange(idx.shape[1], dtype=np.int64),
                   (idx.shape[0], 1))
    full[sel] = idx[sel]
    return _LayerSubsetPlan(gather_idx=full, is_noop=not sel)


def apply_layers_to_params(params: Dict[str, Any], plan,
                           layers: Sequence[int],
                           landed: Optional[List] = None) -> Dict[str, Any]:
    """Chunked subset apply: gather only ``layers``' weight slabs of a
    per-layer plan (placement or replication — anything with an
    ``[L, E|S]`` ``gather_idx``), leaving every other layer's slab
    untouched.  The unit of overlap of asynchronous migration
    (:mod:`repro_torch.serving.async_migrate`): applying every changed
    layer, one call per layer, is exactly equivalent to one
    ``apply_to_params`` of the whole plan."""
    return apply_to_params(params, subset_plan(plan, layers), landed)


def synchronize(params: Dict[str, Any]) -> None:
    """Wait for the weights' device, so a timed window covers the real
    transfer (the host runs ahead of a card; the CPU has nothing to wait
    for)."""
    for group, lname in moe_param_paths(params):
        dev = params[group][lname]["moe"]["w_gate"].device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return

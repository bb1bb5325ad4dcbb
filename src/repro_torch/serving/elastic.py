"""Elastic serving: rank loss and rejoin as first-class serving events.

Counterpart of ``repro.serving.elastic``.  Rank loss and rejoin are
events the engine handles *between iterations*, with no restart, built
on three invariants of the replication subsystem:

- the replication planner's **distinct-rank rule**: an expert with
  ``n_rep >= 2`` has a surviving replica on any single rank loss, so
  masking the dead rank out of the routable tables
  (:meth:`~repro_torch.replication.replica_set.ReplicaSet.masked`) is a
  table flip and those experts stay routable in the same iteration;
- the **staged-commit rule** (a table is routable only after its slab
  landed): recovery and rejoin are ordinary migrations, streamed through
  the :class:`~repro_torch.serving.async_migrate.MigrationExecutor` chunk
  queue or landed whole by the synchronous path;
- the **checkpoint groups** (``serving`` params and the manager's
  ``replication`` state) record where every logical expert's weights
  lived at save time, so a singleton expert whose only slab died with its
  rank is re-materialized from checkpoint rows.

State machine of the :class:`ElasticCoordinator`::

    healthy ──fail_rank──> degraded      (unroutable singletons pending)
                     └───> shrunk        (every expert had a survivor)
    degraded ──recovery chunks land──> shrunk
    shrunk ──rejoin_rank──> warming      (planned slabs streaming)
    warming ──rejoin plan lands──> healthy

Degraded mode: experts with a surviving replica never drop a token;
tokens routed to a lost expert land on the dead rank's zeroed slots and
are counted (``IterStats.lost_tokens``, telemetry ``degraded_iters`` /
``availability``) while its recovery chunk streams ahead of optimization
chunks.  Checkpoints are refused mid-recovery.

Unlike the reference, which builds new arrays, the port zeroes a dead
rank's slabs and writes checkpoint rows into the landing slots **in
place** on the weights' device, as its migrations gather in place: a
second copy of the expert stack does not fit beside the first at full
width.  The checkpoint is read through memory maps
(:func:`repro_torch.checkpoint.ckpt.open_arrays`): only the rows a patch
writes, and the manager's saved ``rep_pos``, leave the disk, and each
patched source row goes up to the card once.

Under a :class:`~repro_torch.models.common.Mesh` each rank holds its
``S/ep`` slots: the dead rank's process zeroes its own slots and every
other rank none, and a patch writes only the slots a rank owns, at their
local indices, from the global checkpoint an EP engine writes
(:func:`repro_torch.checkpoint.ckpt.save` under the mesh).  As in the
reference, whose simulated loss keeps the device in the mesh, the dead
rank's process stays in every collective and serving goes on over the
whole mesh; :meth:`ElasticCoordinator.effective_mesh` names the ranks
that are left.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.models.common import (FSDP_DIM, current_mesh, local_slice,
                                       tensor_parallel)
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.placement.migrate import MOE_WEIGHT_KEYS, moe_param_paths

Tree = Any

STATE_HEALTHY = "healthy"
STATE_DEGRADED = "degraded"    # unroutable experts pending recovery
STATE_SHRUNK = "shrunk"        # dead ranks, every expert routable
STATE_WARMING = "warming"      # rejoined rank streaming its slabs


def _ep_rank():
    """(ep, this rank's index on ``model``) of the current mesh; (1, 0)
    without one."""
    mesh = current_mesh()
    if mesh is None or mesh.size("model") == 1:
        return 1, 0
    return mesh.size("model"), mesh.index("model")


def zero_rank_slabs(params: Tree, rank: int, slots_per_rank: int) -> Tree:
    """Zero every MoE weight row on ``rank``'s physical slots, in place —
    the simulated loss of that rank's expert memory.  Returns ``params``
    (the same tree).  Under a mesh ``params`` hold this rank's slots: the
    dead rank's process zeroes all of them, every other rank none."""
    ep, my = _ep_rank()
    lo, hi = rank * slots_per_rank, (rank + 1) * slots_per_rank
    if ep > 1:
        if rank != my:
            return params
        lo, hi = 0, slots_per_rank
    for group, lname in moe_param_paths(params):
        moe = params[group][lname]["moe"]
        for key in MOE_WEIGHT_KEYS:
            w = moe[key]
            w.narrow(w.dim() - 3, lo, hi - lo).zero_()   # slot axis
    return params


def _local_part(saved_shape, key: str):
    """(the shape this rank holds of an expert stack saved whole as
    ``saved_shape``, the slice of the saved D dim it holds): the ``S/ep``
    slots of its EP rank and, in the tensor-parallel layout, the ``D/data``
    slice its data row holds of each (``embed`` over ``data``, where it
    divides); the whole D dim otherwise."""
    ep, _ = _ep_rank()
    want = list(saved_shape)
    want[-3] //= ep
    dim = len(want) + FSDP_DIM[key]
    cut = slice(0, want[dim])
    mesh = current_mesh()
    if mesh is not None and tensor_parallel(mesh):
        cut = local_slice(want[dim], "embed", mesh)
        want[dim] = cut.stop - cut.start
    return tuple(want), cut


class ElasticCoordinator:
    """Owns the rank-liveness state machine over a
    :class:`~repro_torch.replication.manager.ReplicaManager` and drives
    the degraded-mode / recovery / rejoin flows.  The engine calls
    :meth:`fail_rank` / :meth:`rejoin_rank` on events, passes
    :meth:`recovery_layers` / :meth:`patch_params` into its executor, and
    reports landed layers via :meth:`on_layers_landed`.

    ``ckpt_dir`` points at an engine checkpoint carrying the ``serving``
    params group and the manager's state group — the re-materialization
    source for singleton experts.  Without one, a rank loss that strands
    a singleton is refused (replicated-only losses still work).
    """

    tracer = NULL_TRACER            # optional span tracer (engine-shared)

    def _emit(self, ev: Dict) -> None:
        """Append one elastic event; mirror it as a trace instant."""
        self.events.append(ev)
        if self.tracer.enabled:
            self.tracer.instant(f"elastic.{ev['kind']}", cat="elastic",
                                args={k: v for k, v in ev.items()
                                      if k != "kind"})

    def __init__(self, manager, ckpt_dir: Optional[str] = None,
                 clock=None, telemetry=None):
        if not hasattr(manager, "rsets"):
            raise TypeError("ElasticCoordinator requires a ReplicaManager "
                            "(replica sets are the availability mechanism)")
        self.manager = manager
        self.ckpt_dir = ckpt_dir
        self.clock = clock if clock is not None else time.monotonic
        self.telemetry = telemetry
        # layer index (manager table space) -> lost logical experts
        self.lost: Dict[int, np.ndarray] = {}
        self._warming: set = set()           # rejoined, not yet hosting
        self._fail_t: Optional[float] = None
        self.last_recovery_s: Optional[float] = None
        self.events: List[Dict] = []
        self._saved_cache = None
        self.patched_bytes = 0               # checkpoint bytes written

    # -- state views -------------------------------------------------------
    @property
    def rank_alive(self) -> np.ndarray:
        return self.manager.rank_alive

    @property
    def state(self) -> str:
        if self.lost:
            return STATE_DEGRADED
        if self._warming:
            return STATE_WARMING
        if not self.rank_alive.all():
            return STATE_SHRUNK
        return STATE_HEALTHY

    @property
    def recovering(self) -> bool:
        """Unroutable experts pending re-materialization."""
        return bool(self.lost)

    @property
    def lost_experts(self) -> np.ndarray:
        """Sorted union of unroutable logical experts across layers."""
        if not self.lost:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(list(self.lost.values())))

    def effective_mesh(self, mesh, lost_axis: str = "model"):
        """The mesh minus the dead ``lost_axis`` slices —
        :func:`repro_torch.runtime.elastic.shrink_mesh` applied per dead
        rank (highest index first so earlier indices stay valid).  It
        builds process groups: every rank of the world calls it, in the
        same order."""
        from repro_torch.runtime.elastic import shrink_mesh
        for r in sorted(np.flatnonzero(~self.rank_alive), reverse=True):
            mesh = shrink_mesh(mesh, lost_axis, lost_index=int(r))
        return mesh

    def lost_token_count(self, expert_stats) -> float:
        """Tokens one iteration routed to unroutable experts —
        ``expert_stats [n_blocks, 2, E]`` per-layer (load, vis) counts."""
        if not self.lost:
            return 0.0
        es = np.asarray(expert_stats, np.float64)
        per_layer = (self.manager.per_layer
                     and es.shape[0] == self.manager.n_tables)
        tot = 0.0
        for l, exs in self.lost.items():
            rows = es[l: l + 1] if per_layer else es
            tot += float(rows[:, 0, exs].sum())
        return tot

    # -- events ------------------------------------------------------------
    def fail_rank(self, rank: int, params: Optional[Tree] = None):
        """Handle a rank loss: mask the dead rank out of every routable
        set (experts with a surviving replica stay routable now), record
        unroutable singletons, zero the dead slabs of ``params`` in place
        (when given) and arm an event-triggered replan whose diff
        re-places the strays onto the live ranks.  Returns ``params``.
        Raises, before changing any state, if a stranded singleton has no
        checkpoint to be re-materialized from."""
        rank = int(rank)
        if not self.manager.rank_alive[rank]:
            raise ValueError(f"rank {rank} is already dead")
        alive = self.manager.rank_alive.copy()
        alive[rank] = False
        if not alive.any():
            raise ValueError("cannot fail the last live rank")
        would_lose = any(rs.masked(alive)[1].size
                         for rs in self.manager.rsets)
        if would_lose and not self._has_checkpoint():
            raise RuntimeError(
                f"rank {rank} hosts singleton experts and no checkpoint "
                f"is available to re-materialize them (ckpt_dir="
                f"{self.ckpt_dir!r}) — refusing to drop experts")
        t = self.clock()
        self.manager.rank_alive[rank] = False
        lost = self.manager.mask_dead_ranks()
        for l, exs in lost.items():
            prev = self.lost.get(l)
            self.lost[l] = exs if prev is None \
                else np.unique(np.concatenate([prev, exs]))
        self.manager.must_layers = set(self.lost)
        self._warming.discard(rank)
        if params is not None:
            params = zero_rank_slabs(params, rank,
                                     self.manager.slots_per_rank)
        self.manager.request_replan()
        if self.lost:
            if self._fail_t is None:
                self._fail_t = t
        else:
            # replicated everywhere: availability never broke
            self.last_recovery_s = 0.0
            if self.telemetry is not None:
                self.telemetry.record_recovery(0.0)
        self._emit(dict(kind="fail", rank=rank, t=t,
                        n_lost=int(self.lost_experts.size),
                        state=self.state))
        return params

    def rejoin_rank(self, rank: int) -> None:
        """Handle a rank rejoin: mark it live and arm a replan that
        places replicas there.  The rank stays unroutable until the staged
        plan's slabs land, layer by layer."""
        rank = int(rank)
        if self.manager.rank_alive[rank]:
            raise ValueError(f"rank {rank} is already live")
        self.manager.rank_alive[rank] = True
        self._warming.add(rank)
        self.manager.request_replan()
        self._emit(dict(kind="rejoin", rank=rank, t=self.clock(),
                        state=self.state))

    # -- executor hooks ----------------------------------------------------
    def recovery_layers(self, plan) -> List[int]:
        """The plan's chunk layers that carry re-materialization of
        unroutable experts — the executor orders these first."""
        return [l for l in self.manager.plan_layers(plan) if l in self.lost]

    def on_layers_landed(self, plan, layers) -> None:
        """Engine callback after ``commit_layers(plan, layers)``: clears
        the recovered experts, stamps ``recovery_s`` when the last one
        lands, and retires the warming state once the rejoin plan has
        fully landed and the rank hosts replicas again."""
        now = self.clock()
        recovered = False
        for layer in layers:
            layer = int(layer)
            if layer in self.lost:
                del self.lost[layer]
                recovered = True
        if recovered:
            self.manager.must_layers = set(self.lost)
        if not self.lost and self._fail_t is not None:
            self.last_recovery_s = now - self._fail_t
            self._fail_t = None
            if self.telemetry is not None:
                self.telemetry.record_recovery(self.last_recovery_s)
            self._emit(dict(kind="recovered", t=now,
                            recovery_s=self.last_recovery_s,
                            state=self.state))
        if self._warming and self.manager.in_flight is None:
            for r in sorted(self._warming):
                if self.manager.hosts_rank(r):
                    self._warming.discard(r)
                    self._emit(dict(kind="warm", rank=r, t=now,
                                    state=self.state))

    # -- checkpoint re-materialization -------------------------------------
    def _has_checkpoint(self) -> bool:
        if self.ckpt_dir is None:
            return False
        return (ckpt_lib.has_group(self.ckpt_dir, "serving")
                and ckpt_lib.has_group(self.ckpt_dir,
                                       self.manager.ckpt_group))

    def _saved(self, paths: List[str]):
        """(maps of the saved weights ``paths`` of the ``serving`` group,
        saved ``rep_pos [T, E, R]``, saved n_tables) — where each logical
        expert's weights lived at save time.  Nothing but ``rep_pos`` is
        read until a patch indexes a map."""
        if self._saved_cache is None:
            if not self._has_checkpoint():
                raise RuntimeError(
                    f"no checkpoint with 'serving' + "
                    f"{self.manager.ckpt_group!r} groups under "
                    f"{self.ckpt_dir!r} to re-materialize lost experts from")
            (mm, _), = ckpt_lib.open_arrays(
                self.ckpt_dir, self.manager.ckpt_group, ["rep_pos"]).values()
            rep_pos = np.asarray(mm, np.int64)
            if rep_pos.ndim == 2:
                rep_pos = rep_pos[None]
            self._saved_cache = ({}, rep_pos, rep_pos.shape[0])
        maps, rep_pos, nt = self._saved_cache
        todo = [p for p in paths if p not in maps]
        if todo:
            maps.update(ckpt_lib.open_arrays(self.ckpt_dir, "serving", todo))
        return maps, rep_pos, nt

    def invalidate_checkpoint_cache(self) -> None:
        """Forget the opened checkpoint (call after a new save)."""
        self._saved_cache = None

    def patch_params(self, params: Tree, plan, layers) -> Tree:
        """Write the checkpoint rows of the lost experts in ``layers`` into
        their landing slots, in place — the slab gather sourced them from
        the dead (zeroed) slot.  Called between a gather and its commit, so
        a new table flips only once its slots hold the true weights.
        Returns ``params``."""
        todo = [int(l) for l in layers if int(l) in self.lost]
        if not todo:
            return params
        paths = {f"params|{g}|{n}|moe|{k}": (g, n, k)
                 for g, n in moe_param_paths(params) for k in MOE_WEIGHT_KEYS}
        maps, saved_pos, saved_nt = self._saved(list(paths))
        new_sets = getattr(plan, "new_sets", None)
        ep, _ = _ep_rank()
        for path, (group, lname, key) in paths.items():
            w = params[group][lname]["moe"][key]
            if path not in maps:
                raise KeyError(f"checkpoint missing {path!r}")
            saved, ext = maps[path]
            want, d_cut = _local_part(saved.shape, key)
            if saved.shape[-3] % ep or tuple(w.shape) != want:
                raise ValueError(
                    f"checkpoint {path!r} shape {tuple(saved.shape)} holds "
                    f"{want} on this rank, not its {tuple(w.shape)} — "
                    "geometry changed")
            self._patch_weight(w, saved, ext, saved_pos, saved_nt, plan,
                               new_sets, todo, (FSDP_DIM[key], d_cut))
        return params

    def _patch_weight(self, w, saved, ext, saved_pos, saved_nt, plan,
                      new_sets, layers, d_part) -> None:
        """One weight tensor: write each lost expert's saved primary row
        into its destination slots.  ``[L, S, ...]`` stacked weights are
        row-patched per plan layer (per-layer manager) or across the whole
        stack (shared plan); ``[S, ...]`` weights on the slot axis.  Each
        distinct source row is read and uploaded once, then copied on the
        device to every slot it lands in.  ``d_part = (dim, slice)``: the
        part of each saved row's D dim this rank holds."""
        stacked = w.dim() == 4
        per_layer_plan = new_sets is not None
        by_layer = stacked and per_layer_plan and self.manager.n_tables > 1
        n_loc = w.shape[-3]                # this rank's slots (all: ep 1)
        lo = _ep_rank()[1] * n_loc
        writes: Dict[Any, List] = {}      # layer (or None) -> [(dst, src)]
        for l in layers:
            new_set = new_sets[l] if per_layer_plan else plan.new_set
            spos = saved_pos[l if saved_nt > 1 else 0]
            for ex in self.lost[l]:
                src = int(spos[ex, 0])   # saved primary slot of ex
                dests = np.unique(
                    new_set.rep_pos[ex, :new_set.n_rep[ex]]).astype(int)
                for dst in dests:
                    if lo <= dst < lo + n_loc:     # a slot this rank owns
                        writes.setdefault(l if by_layer else None,
                                          []).append((int(dst) - lo, src))
        for l, pairs in writes.items():
            srcs = sorted({s for _, s in pairs})
            if l is not None:
                rows = saved[l, srcs]                       # [n, a, b]
            elif stacked:
                rows = saved[:, srcs]                       # [L, n, a, b]
            else:
                rows = saved[srcs]
            dim, cut = d_part
            rows = rows[(Ellipsis, cut) + (slice(None),) * (-1 - dim)]
            up = ckpt_lib.decode_rows(rows, ext).to(device=w.device,
                                                    dtype=w.dtype)
            self.patched_bytes += up.numel() * up.element_size()
            pick = torch.as_tensor([srcs.index(s) for _, s in pairs],
                                   dtype=torch.long, device=w.device)
            dst = torch.as_tensor([d for d, _ in pairs], dtype=torch.long,
                                  device=w.device)
            if l is not None:
                w[l].index_copy_(0, dst, up.index_select(0, pick))
            elif stacked:
                w.index_copy_(1, dst, up.index_select(1, pick))
            else:
                w.index_copy_(0, dst, up.index_select(0, pick))

"""Batched serving engine of the port: chunked token-budgeted prefill,
one-shot prefill and batched decode with ReaLB active, with expert
placement or replication and live migration.

Counterpart of ``repro.serving.engine.Engine``, on one device or, under
a mesh (``models.common.use_mesh``), on every rank of an EP group: each
rank runs the same scheduler and the same seeded sampling on the same
logits, so every rank emits the same tokens, while each holds its
``S/ep`` expert slots.  The engine holds one device-resident KV
cache of ``max_slots`` sequences.  Each iteration packs up to
``prefill_budget`` prompt tokens across every slot with pending prefill
work into one ``[max_slots, bucket]`` chunk forward, then runs one batched
decode step over the decode-ready slots.  A request that carries
``vision_embeds``, every request of a stack that cannot continue a
chunk (Mamba, MLA, cross-attention or an encoder-decoder), or every
request when ``prefill_budget=0``, is prefilled whole in a batch-1
``prefill_forward`` at admission and its cache copied into its slot.  A
VLM request carries its ``n_vision_tokens`` rows of vision embeddings;
an encoder-decoder request carries its ``enc_seq_len`` frame embeddings
in the same field (none: a zero memory, as the reference's); both are
the memory of the stack's cross-attention, whose K/V the prefill caches
and every decode reads.  The AIMD ``m_state`` of ReaLB persists across
iterations; per-iteration routing stats are kept in ``self.stats`` and fed,
with every finished request, to an optional
:class:`~repro_torch.serving.telemetry.Telemetry`.  ``virtual_ep`` sizes
the policy's virtual EP topology.  ``temperature > 0`` samples from
``softmax(logits / temperature)`` on the device with a ``torch.Generator``
seeded by ``seed`` (JAX's PRNG draws are not reproduced); 0 is greedy.
``save_checkpoint``/``load_checkpoint`` write and read the reference's
format; under a mesh the checkpoint holds the global layout (rank 0
writes it, the expert stacks gathered to it a block at a time) and a load
reads each rank's slots, for any EP size.

Placement and replication: a
:class:`~repro_torch.placement.PlacementManager` or
:class:`~repro_torch.replication.ReplicaManager` (``placement=``) is fed
every iteration's expert stats, and at its cadence stages a plan.  The
engine gathers the plan's weight slabs in place, between iterations (no
forward runs meanwhile), and only then commits the plan, so a table never
routes into weights that have not landed.  A failed gather takes the
landed blocks back to the old layout and aborts the plan.  With
``migrate_async`` a staged plan drains as byte-budgeted per-layer chunks
through a :class:`~repro_torch.serving.async_migrate.MigrationExecutor`,
one batch an iteration, each landed layer's table committed on its own.
Under a mesh the tables are global and a rank gathers into its own
``S/ep`` slots, the rows held by other ranks coming over the EP group;
every rank applies the same plan in the same chunks (the seconds that
size a budget or feed the bandwidth EWMA, and those the profiler and a
cost gate read, are agreed over the ranks), and a failure on any rank
takes the landed blocks back on every rank.
The device tables are uploaded once per committed change (or weighted-split
refresh), so no forward uploads them.  ``capacity_margin`` lets a replica
manager shrink the dispatch capacity to its post-split predicted peak.
Migration bytes and seconds are charged to the clock and reported in the
next :class:`IterStats`; spans go to ``tracer``.

Elastic serving: an :class:`~repro_torch.serving.elastic.
ElasticCoordinator` over the replica manager (``elastic=``) turns a rank
loss or rejoin into an event between iterations (``fail_rank`` /
``rejoin_rank``, or scripted by a :class:`~repro_torch.runtime.
fault_tolerance.FaultInjector`): the dead rank's slabs are zeroed in place
and masked out of the tables, lost experts are re-materialized from the
checkpoint into their new slots before the recovery plan commits, and
``IterStats.n_unroutable`` / ``lost_tokens`` count the degraded window.
Under a mesh the dead rank's process zeroes its own slots and stays in
every collective (the reference's simulated loss keeps its device), so
serving goes on over the whole mesh.

The compiled step (the counterpart of the reference's ``_build``, which
jits its forwards): every chunk and decode forward runs over the static
input, cache, state and table buffers of :class:`~repro_torch.serving.
graphs.StepGraphs`, one key a chunk bucket and one for decode.  A one-
device engine on a card captures each key as a CUDA graph after its first
(eager) call and replays it after.  ``graphs=False`` runs the same step
uncaptured (the counterpart of ``jax.disable_jit()``), as the engine
always does under a mesh (capturing the EP collectives over NCCL is not
ported) and on the CPU (where ``graphs=True`` is refused).  The one-shot
prefill stays eager.  The cache, ``m_state`` and the tables (``copy_`` at
every commit, refresh or elastic mask) are written in place, so a replay
reads them with no recapture; an event that replaces a weight tensor
drops the graphs, and they are captured again.

Observation: a :class:`~repro_torch.obs.profiler.Profiler` (``profiler=``)
is fed every recorded iteration's stats and forward seconds, from the
forward's start to its statistics on the host, so a forward that returns
once enqueued is timed to the end of its device work (and its drift EWMA
calibrates an unwired cost gate); a
:class:`~repro_torch.analysis.sentinel.Sentinel` (``sentinel=``) guards
each iteration's hot window against device→host syncs outside the two
sanctioned reads (the sampled tokens and the stats) and counts the input
signatures of the forwards that run uncaptured and the captures of those
that are graphed.  With all of these ``None`` the engine
runs as without them, bit for bit.  On a card every host→device upload of
the hot loop is asynchronous (from pinned memory), so no upload syncs.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig, ReaLBConfig
from repro_torch.core import ep_moe
from repro_torch.core.policy import init_m_state
from repro_torch.models import transformer as tf
from repro_torch.analysis.sentinel import NULL_SENTINEL
from repro_torch.models.common import (DTYPES, current_mesh, ep_size,
                                       local_slice, resolve_device,
                                       tensor_parallel)
from repro_torch.obs.profiler import NULL_PROFILER
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.placement import migrate as pmigrate
from repro_torch.replication import migrate as rmigrate
from repro_torch.serving.async_migrate import MigrationExecutor
from repro_torch.serving.graphs import StepGraphs
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.serving.telemetry import Telemetry


@dataclasses.dataclass
class IterStats:
    """Per-iteration routing/balance diagnostics (benchmark input)."""
    n_active: int
    tokens: int                  # real (non-padding) tokens this iteration
    ib_global: float
    fp4_ranks: float
    gate_open: float
    phase: str = "decode"        # "prefill" | "decode"
    t_wall: float = 0.0          # engine clock at record time
    batch_tokens: int = 0        # tokens the MoE actually saw (incl. pad)
    vis_frac: float = 0.0        # vision fraction of routed assignments
    drop_frac: float = 0.0       # capacity-dropped fraction of routed tokens
    migration_bytes: int = 0     # expert weight bytes moved before this
    #                              iter (integral end-to-end: plans count
    #                              whole weight bytes, never fractions)
    migration_s: float = 0.0     # migration seconds that stalled serving
    #                              (charged to a virtual clock; measured
    #                              wall seconds under wall clocks)
    migration_hidden_s: float = 0.0  # transfer seconds hidden under the
    #                              iteration's forward
    split_frac: float = 0.0      # routed fraction served by a non-primary
    #                              replica (0 under a bijective table)
    n_unroutable: int = 0        # logical experts with no live replica
    #                              (elastic degraded mode; 0 when healthy)
    lost_tokens: float = 0.0     # tokens this iteration routed to an
    #                              unroutable expert (they landed on the
    #                              dead rank's zeroed slots)


def _bucket(n: int, lo: int = 8) -> int:
    """Round a chunk length up to a power of two (the reference's jit
    buckets: the same padded shapes, so the same routing statistics)."""
    b = lo
    while b < n:
        b *= 2
    return b


class Engine:
    def __init__(self, cfg: ModelConfig, params, rcfg: ReaLBConfig,
                 max_slots: int = 8, max_len: int = 256,
                 temperature: float = 0.0, seed: int = 0,
                 prefill_budget: int = 256, text_reserve: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 telemetry: Optional[Telemetry] = None,
                 cost_model=None, placement=None,
                 virtual_ep: Optional[int] = None,
                 capacity_margin: Optional[float] = None,
                 migrate_async: bool = False,
                 migrate_bytes_per_iter: Optional[int] = None,
                 elastic=None, fault_injector=None, tracer=None,
                 profiler=None, sentinel=None, device=None, graphs=None):
        mesh = current_mesh()
        self.device = mesh.device if device is None and mesh is not None \
            else resolve_device(device)
        self.cfg, self.params, self.rcfg = cfg, params, rcfg
        # invariant sentinel; None -> the shared no-op
        self.sentinel = NULL_SENTINEL if sentinel is None else sentinel
        # span tracer; None -> the shared no-op singleton.  Shared with the
        # manager and the elastic coordinator so their spans land on the
        # same timeline.
        self.tracer = NULL_TRACER if tracer is None else tracer
        if tracer is not None:
            if placement is not None:
                placement.tracer = tracer
            if elastic is not None:
                elastic.tracer = tracer
        # hot-loop profiler; None -> the shared no-op singleton
        self.profiler = NULL_PROFILER if profiler is None else profiler
        if profiler is not None and placement is not None:
            # the measured/predicted drift EWMA prices the savings side of
            # a cost gate that was left unwired
            gate = getattr(placement, "cost_gate", None)
            if gate is not None \
                    and getattr(gate, "time_scale", False) is None:
                gate.time_scale = profiler.time_scale
        self.max_slots, self.max_len = max_slots, max_len
        self.temperature = temperature
        self.prefill_budget = prefill_budget
        # chunk continuation needs a plain GQA/MQA decoder stack: an SSM,
        # hybrid, MLA, cross-attention or encoder-decoder stack prefills
        # each prompt in one shot
        self.chunked = (prefill_budget > 0 and cfg.mla is None
                        and cfg.ssm is None and not cfg.is_encdec
                        and cfg.layer_pattern == "attn"
                        and cfg.family != "vlm")
        self.scheduler = Scheduler(max_slots, text_reserve=text_reserve)
        self.clock = clock
        self.telemetry = telemetry
        # virtual-time mode: an object with .cost(batch_tokens) -> seconds,
        # paired with a clock exposing .advance(dt), advanced right after
        # each forward, before first-token/finish timestamps are stamped
        self.cost_model = cost_model
        # expert placement: a PlacementManager or ReplicaManager (or None);
        # its EP group sizes the policy topology, whose slots the table's
        # positions are strided by
        self._placement = placement
        mesh_ep = ep_size(mesh)
        if mesh is not None:
            # every rank runs this engine: the same scheduler, the same
            # seeded sampling, the same tokens; the tables are global and
            # each rank holds its S/ep slots of the weights
            if virtual_ep is not None and virtual_ep != mesh_ep:
                raise ValueError(f"virtual_ep={virtual_ep} under a mesh of "
                                 f"EP {mesh_ep}")
            if placement is not None and placement.ep != mesh_ep:
                raise ValueError(f"placement plans {placement.ep} ranks, "
                                 f"mesh EP={mesh_ep}")
            if sentinel is not None:
                # the staged backend's host copies are sanctioned pulls
                ep_moe._dist_comm(mesh).sentinel = sentinel
        if placement is not None and virtual_ep is not None \
                and placement.ep != virtual_ep:
            raise ValueError(f"placement plans {placement.ep} ranks, "
                             f"virtual_ep={virtual_ep}")
        if virtual_ep is None and placement is not None:
            virtual_ep = placement.ep
        if placement is not None and cfg.moe is not None:
            # a replica manager routes over S >= E physical slots: refuse
            # params that were not laid out for it (misrouting otherwise)
            tables = placement.device_tables()
            want = (int(tables[2].shape[-1]) if len(tables) >= 3
                    else cfg.moe.num_experts) // mesh_ep
            paths = pmigrate.moe_param_paths(params)
            if paths:
                g0, l0 = paths[0]
                got = params[g0][l0]["moe"]["w_gate"].shape[-3]
                if got != want:
                    raise ValueError(
                        f"params hold {got} expert slots but the manager "
                        f"routes over {want}; lay the weights out with "
                        "repro_torch.replication.expand_moe_params first")
        # replica-aware dispatch capacity: with a margin set, the factor
        # follows the post-split predicted peak rank load
        self.capacity_margin = capacity_margin
        self._base_capacity = cfg.moe.capacity_factor if cfg.moe else 0.0
        # async migration: drain staged plans as byte-budgeted per-layer
        # chunks instead of one synchronous whole-plan apply
        self.migrate_async = migrate_async
        self.migrate_bytes_per_iter = migrate_bytes_per_iter
        self._mig: Optional[MigrationExecutor] = None
        self._iter_s: Optional[float] = None  # EWMA of iteration seconds
        # (bytes, stall_s, hidden_s) staged for the next IterStats
        self._pending_migration = (0, 0.0, 0.0)
        # cumulative engine-side accounting (also covers drains that never
        # reach a _record, e.g. drain_migrations() after the last request)
        self.migration_bytes_moved = 0
        self.migration_stall_s = 0.0
        self.migration_hidden_s = 0.0
        # elastic serving: a coordinator over the same manager turns rank
        # loss/rejoin into between-iteration events; a FaultInjector
        # scripts them (polled once per step)
        self._elastic = elastic
        self._fault = fault_injector
        if elastic is not None and (
                placement is None
                or getattr(elastic, "manager", None) is not placement):
            raise ValueError("the elastic coordinator must wrap this "
                             "engine's manager")
        # device copies of the tables, written in place at every change
        self._place_bufs: Optional[tuple] = None
        self._place_stale = True
        self._it = 0
        self.cache = tf.init_cache(cfg, max_slots, max_len, self.device)
        self.m_state = init_m_state(
            *ep_moe.moe_state_shape(mesh, max_slots, virtual_ep=virtual_ep),
            rcfg, device=self.device)
        self._mesh = mesh
        self.pos = np.zeros(max_slots, np.int32)      # next write position
        self.last_tok = np.zeros(max_slots, np.int32)
        self.active_mask = np.zeros(max_slots, bool)
        self.decode_ready = np.zeros(max_slots, bool)
        self.mod_state = np.zeros(max_slots, bool)    # decode-token modality
        self._prefill_fifo: List[int] = []            # slots mid-prefill
        # aux scalars come back summed over the layers; normalize to
        # per-MoE-layer means so duty cycles / IB read as true fractions
        self._n_moe = max(sum(1 for f in cfg.ffn_kinds() if f == "moe"), 1)
        self.stats: List[IterStats] = []
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # the compiled step: every chunk and decode forward runs over the
        # static buffers of StepGraphs, captured on a one-device card
        # engine unless graphs=False, uncaptured under a mesh and on the CPU
        if graphs is None:
            graphs = mesh is None and self.device.type == "cuda"
        if graphs and mesh is not None:
            raise ValueError("graphs=True under a mesh: the EP engine runs "
                             "eager (capture over NCCL is not ported)")
        if graphs and self.device.type != "cuda":
            raise ValueError("graphs=True on the CPU: CUDA graphs need a "
                             "card")
        self._graphs = StepGraphs(self.device, self.sentinel,
                                  capture=bool(graphs))
        self.step_mode = "graphed" if graphs else "eager (" + (
            "EP mesh: capture over NCCL not ported" if mesh is not None
            else "CPU" if self.device.type != "cuda" else "graphs=False") \
            + ")"
        logging.getLogger(__name__).info("serving step: %s", self.step_mode)
        self.sentinel.note_step(self.step_mode)
        # the three forwards, looked up at each call; a sentinel counts the
        # input signatures of those that run uncaptured (a captured
        # forward's captures are counted by its key)
        self._fwd = {name: _entry(name)
                     for name in ("prefill", "chunk", "decode")}
        self._counted = {name: self.sentinel.register_entry(name, fn)
                         for name, fn in self._fwd.items()}

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        """``a`` on the engine's device; on a card from pinned memory,
        asynchronously (a pageable upload would wait for the stream)."""
        t = torch.as_tensor(np.asarray(a), dtype=dtype)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _place_args(self):
        """The device tables of the routable plan — (e2r, local_slot) for a
        placement manager, (rep_pos, n_rep, slot_owner[, split_sched]) for
        a replica manager, None without one.  Written once per commit,
        weighted-split refresh or elastic mask, into the same buffers
        (``copy_``) while their shapes hold, so no forward uploads them
        and a captured step reads the new tables."""
        if self._placement is None:
            return None
        if self._place_stale:
            tables = [np.asarray(a) for a in self._placement.device_tables()]
            bufs = self._place_bufs
            if bufs is not None and len(bufs) == len(tables) and all(
                    tuple(b.shape) == a.shape
                    and b.dtype == torch.as_tensor(a).dtype
                    for b, a in zip(bufs, tables)):
                for b, a in zip(bufs, tables):
                    b.copy_(self._host(a), non_blocking=True)
            else:
                self._place_bufs = tuple(self._tensor(a) for a in tables)
            self._place_stale = False
        return self._place_bufs

    def _host(self, a) -> torch.Tensor:
        """``a`` as a host tensor, pinned on a card (for an asynchronous
        upload)."""
        t = torch.as_tensor(np.asarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _forward(self, name: str, arrays: Dict[str, np.ndarray]):
        """One ``chunk`` or ``decode`` forward on the host inputs
        ``arrays``: ``(logits, aux)``.  The inputs are written into the
        key's static buffers, the cache and ``m_state`` in place by the
        step, which is replayed once captured (the outputs then are the
        graph's: read them before the next forward)."""
        place = self._place_args()
        sg = self._graphs
        fwd = self._fwd[name] if sg.capture else self._counted[name]
        key = (name, tuple((k, v.shape) for k, v in arrays.items()),
               () if place is None else tuple(tuple(t.shape) for t in place))
        batch = sg.inputs(key, arrays)
        cfg, rcfg = self.cfg, self.rcfg

        def body(params, cache, m_state, place):
            res = fwd(params, cfg, rcfg, batch, cache, m_state,
                      placement=place)
            m_state.copy_(res.m_state)
            return res.logits, res.aux

        return sg.run(
            name, key, body, (self.params, self.cache, self.m_state, place),
            rebuild=cfg.moe.capacity_factor if cfg.moe else None)

    def _begin(self, name: str) -> list:
        """A forward starts: ``[name, engine-clock start, tracer-clock
        start, span args]`` for :meth:`_done`."""
        return [name, self.clock(),
                self.tracer.clock() if self.tracer.enabled else 0.0, None]

    def _done(self, fwd: list) -> float:
        """The forward ``fwd`` (from :meth:`_begin`) is complete: its
        outputs have reached the host.  Its seconds on the engine clock,
        and its ``forward.<name>`` span, run to here, so a forward that
        returned once enqueued (a graph's replay, or any forward on a
        card) is timed to the end of its device work."""
        name, t0, tt0, args = fwd
        if self.tracer.enabled:
            self.tracer.complete(f"forward.{name}", tt0,
                                 self.tracer.clock() - tt0, cat="forward",
                                 args=args)
        return self.clock() - t0

    # -- live migration ------------------------------------------------------
    def _undo_plan(self, plan):
        """The gather taking ``plan``'s layout back to the routable one
        (the diff of its new tables against the manager's current ones):
        what a failed in-place apply runs over the blocks that landed."""
        mgr = self._placement
        if isinstance(plan, rmigrate.LayerReplicaMigrationPlan):
            return rmigrate.diff_layers(plan.new_sets, mgr.rsets)
        if isinstance(plan, rmigrate.ReplicaMigrationPlan):
            return rmigrate.diff(plan.new_set, mgr.rset)
        if isinstance(plan, pmigrate.LayerMigrationPlan):
            return pmigrate.diff_layers(plan.new_tables, mgr.tables)
        return pmigrate.diff(plan.new_table, mgr.table)

    def _maybe_migrate(self):
        """The per-iteration migration state machine.

        Draining: advance the in-flight chunk queue by one byte-budgeted
        batch (no new replan can fire — the manager guards it).  Idle:
        ask the manager for a staged plan; apply it synchronously, or
        start an async executor and drain its first batch."""
        if self._placement is None or self.cfg.moe is None:
            return
        if self._mig is not None:
            self._drain_migration()
            return
        plan = self._placement.maybe_replan(self._it)
        if plan is None:
            return
        if self.migrate_async:
            prio = patch = None
            if self._elastic is not None:
                # recovery chunks drain ahead of optimization chunks; the
                # patch writes checkpoint rows into the landed slots
                # before their commit
                prio = self._elastic.recovery_layers(plan)
                patch = self._elastic.patch_params
            self._mig = MigrationExecutor(
                self._placement, plan,
                bytes_per_iter=self.migrate_bytes_per_iter,
                priority_layers=prio, patch_fn=patch,
                undo=self._undo_plan(plan))
            self._drain_migration()
            return
        # synchronous path: the whole slab permutation lands between two
        # iterations, timed (one device synchronize) for the measured-
        # bandwidth EWMA and the charged seconds under wall clocks
        undo = self._undo_plan(plan)
        landed: List = []
        t0 = time.perf_counter()
        try:
            pmigrate.apply_to_params(self.params, plan, landed)
            pmigrate.synchronize(self.params)
        except BaseException as err:
            # the old tables stay routable: drop the staged plan, take the
            # landed blocks back to their layout, surface the error
            pmigrate.roll_back(err, self.params, undo, landed,
                               self._placement.abort)
            raise
        wall = pmigrate.agree_seconds(time.perf_counter() - t0)
        self._placement.bandwidth.observe(plan.moved_bytes, wall)
        layers = self._placement.plan_layers(plan)
        err = None
        if self._elastic is not None:
            # lost experts' slabs were gathered from the dead (zeroed)
            # slots: write their checkpoint rows before the new tables
            # flip routable, outside the timed window
            try:
                self._elastic.patch_params(self.params, plan, layers)
                pmigrate.synchronize(self.params)
            except BaseException as e:
                err = e
        try:          # under a mesh: every rank landed it, or none commits
            pmigrate.agree_ok(err is None, "its patch of a migration")
        except pmigrate.PeerMigrationError as e:
            err = e
        if err is not None:
            pmigrate.roll_back(err, self.params, undo, landed,
                               self._placement.abort)
            raise err
        # staged plans become routable only after the slabs landed
        self._placement.commit(plan)
        self._place_stale = True                  # table changed
        if hasattr(self.clock, "advance"):
            secs = self._placement.migration_seconds(plan.moved_bytes)
            self.clock.advance(secs)
        else:
            # wall clocks: the move is real work already on the wall
            secs = wall
        self._charge_migration(int(plan.moved_bytes), secs, 0.0)
        trc = self.tracer
        if trc.enabled:
            # one migration.drain span per charge: summed durations
            # reconcile exactly with stall + hidden telemetry totals
            trc.complete("migration.drain", self.clock() - secs, secs,
                         cat="migration",
                         args={"mode": "sync",
                               "bytes": int(plan.moved_bytes),
                               "stall_s": secs, "hidden_s": 0.0,
                               "layers": len(layers)})
            trc.instant("table.commit", cat="migration",
                        args={"layers": len(layers), "done": True})
        self._notify_plan_committed()
        if self._elastic is not None:
            self._elastic.on_layers_landed(plan, layers)

    def _drain_migration(self):
        """One budgeted chunk batch of the in-flight plan: land the
        slabs, commit exactly those layers, split the transfer seconds
        into hidden (fits the budget — overlapped with this iteration's
        forward) and stall (the excess, charged to a virtual clock)."""
        plan = self._mig.plan
        try:
            self.params, rep = self._mig.drain(self.params, self._iter_s)
        except BaseException:
            # the executor aborted the staged remainder; layers committed
            # by earlier batches stay routable (their slabs did land)
            self._mig = None
            self._place_stale = True
            raise
        self._place_stale = True              # landed layers' tables flipped
        if hasattr(self.clock, "advance"):
            stall = self._placement.migration_seconds(rep.excess_bytes)
            hidden = self._placement.migration_seconds(
                rep.nbytes - rep.excess_bytes)
            self.clock.advance(stall)
        else:
            # the gathers run on the forward's stream, between forwards:
            # on wall clocks the whole batch is an honest stall
            stall, hidden = rep.wall_s, 0.0
        if rep.done:
            self._mig = None
        self._charge_migration(rep.nbytes, stall, hidden)
        trc = self.tracer
        if trc.enabled:
            # span starts at the stall charge and extends through the
            # hidden share; dur = stall + hidden
            trc.complete("migration.drain", self.clock() - stall,
                         stall + hidden, cat="migration",
                         args={"mode": "async", "bytes": int(rep.nbytes),
                               "stall_s": stall, "hidden_s": hidden,
                               "layers": len(rep.layers),
                               "done": bool(rep.done)})
            if rep.layers:
                trc.instant("table.commit", cat="migration",
                            args={"layers": len(rep.layers),
                                  "done": bool(rep.done)})
        if rep.done:
            self._notify_plan_committed()
        if self._elastic is not None and rep.layers:
            # the landed layers' lost experts are re-materialized (the
            # executor's patch ran before the commit): clear them, stamp
            # recovery_s / warm-up completion
            self._elastic.on_layers_landed(plan, rep.layers)

    def _charge_migration(self, nbytes: int, stall_s: float,
                          hidden_s: float):
        b, s, h = self._pending_migration
        self._pending_migration = (b + int(nbytes), s + stall_s,
                                   h + hidden_s)
        self.migration_bytes_moved += int(nbytes)
        self.migration_stall_s += stall_s
        self.migration_hidden_s += hidden_s

    def _notify_plan_committed(self):
        """A staged plan fully landed: count the commit and open a fresh
        prediction-accuracy window stamped with the predictor's per-layer
        rank loads under the new tables."""
        if self.telemetry is None:
            return
        self.telemetry.record_plan_commit()
        if self._placement is not None \
                and hasattr(self._placement, "predicted_rank_loads"):
            self.telemetry.open_prediction_window(
                self._it, self._placement.predicted_rank_loads())

    @property
    def migration_draining(self) -> bool:
        """A staged plan's chunk queue is mid-flight."""
        return self._mig is not None and self._mig.draining

    def drain_migrations(self, max_iters: int = 10_000) -> None:
        """Finish any in-flight migration without serving (e.g. before a
        checkpoint): budget-sized batches keep landing until the queue
        is empty."""
        it = 0
        while self.migration_draining:
            it += 1
            assert it <= max_iters, "migration drain failed to converge"
            self._drain_migration()

    def _abort_migration(self) -> None:
        """Drop any in-flight or staged plan.  Layers already committed
        stay routable — their slabs did land."""
        if self._mig is not None:
            self._mig.cancel()
            self._mig = None
        elif getattr(self._placement, "in_flight", None) is not None:
            self._placement.abort()
        self._place_stale = True

    # -- elastic serving events ----------------------------------------------
    def fail_rank(self, rank: int) -> None:
        """Simulate the loss of EP ``rank`` between iterations: the plan in
        flight (computed for the old rank set) is aborted, the dead rank
        is masked out of the routable tables (experts with a surviving
        replica stay routable this same iteration), its weight slabs are
        zeroed in place, and the coordinator arms a recovery replan."""
        if self._elastic is None:
            raise RuntimeError("fail_rank requires an ElasticCoordinator")
        self._abort_migration()
        self.params = self._elastic.fail_rank(rank, self.params)
        self._place_stale = True                  # tables were masked

    def rejoin_rank(self, rank: int) -> None:
        """The returning rank becomes plannable; it turns routable layer
        by layer as the warm-up plan's slabs land (staged commit)."""
        if self._elastic is None:
            raise RuntimeError("rejoin_rank requires an ElasticCoordinator")
        self._elastic.rejoin_rank(rank)

    def _maybe_resize_capacity(self):
        """Replica-aware capacity: shrink (or restore) the dispatch
        ``capacity_factor`` to the post-split predicted peak rank load,
        re-checked every iteration so drift under an unchanged replica
        set re-grows the buffer.  The reference re-jits its steps on a
        move of 5 % or more; the eager port replaces ``cfg.moe`` at the
        same iterations, to the same factor (the capacity sets the
        dispatch buckets, and with them the drop stats)."""
        if (self.capacity_margin is None or self.cfg.moe is None
                or not hasattr(self._placement, "capacity_factor")):
            return
        eff = min(self._placement.capacity_factor(self.capacity_margin),
                  self._base_capacity)
        cur = self.cfg.moe.capacity_factor
        if abs(eff - cur) / max(cur, 1e-9) < 0.05:
            return
        self.cfg = dataclasses.replace(
            self.cfg, moe=dataclasses.replace(self.cfg.moe,
                                              capacity_factor=eff))
        # a deliberate change of the forwards' static config: declared, so
        # the sentinel attributes its new signatures to the resize band
        self.sentinel.note_rebuild(f"capacity_factor {cur:.4f}->{eff:.4f}")

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request):
        if req.prompt_len + req.max_new_tokens > self.max_len:
            raise ValueError(f"request needs {req.prompt_len} + "
                             f"{req.max_new_tokens} > max_len {self.max_len}")
        cfg = self.cfg
        if cfg.family == "vlm" or cfg.is_encdec:
            # the memory's K/V fill the slot's xk/xv rows: the reference's
            # cache insert fails on any other count (a VLM request without
            # embeds in its prefill)
            rows = tf.memory_len(cfg)
            got = None if req.vision_embeds is None \
                else np.shape(req.vision_embeds)[0]
            if got != rows and (cfg.family == "vlm" or got is not None):
                raise ValueError(f"request {req.uid}: {got} rows of memory "
                                 f"embeds, {cfg.name} attends to {rows}")
        if req.arrival_time is None:
            req.arrival_time = self.clock()
        self.scheduler.submit(req)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """The next token of every row, drawn on the device; pulling it is
        the one host read that serving requires (a sanctioned sync)."""
        toks = sample_tokens(logits, self.temperature, self._gen) \
            .to(torch.int32)
        with self.sentinel.sanctioned("sample"):
            return toks.cpu().numpy()

    def _tick(self, batch_tokens: int):
        """Advance a virtual clock by the modeled cost of one forward."""
        if self.cost_model is not None and hasattr(self.clock, "advance"):
            self.clock.advance(self.cost_model.cost(batch_tokens))

    def _record(self, *, phase: str, n_active: int, tokens: int,
                batch_tokens: int, aux: Dict[str, Any], fwd: list):
        """Pull the iteration's stats to the host (with the sampled tokens,
        the host reads serving makes, all after the forward; a sanctioned
        sync), end the forward ``fwd`` (:meth:`_done`) there, record the
        stats and feed the manager and the profiler."""
        with self.sentinel.sanctioned("telemetry"):
            self._record_stats(phase=phase, n_active=n_active,
                               tokens=tokens, batch_tokens=batch_tokens,
                               aux=aux, fwd=fwd)

    def _record_stats(self, *, phase: str, n_active: int, tokens: int,
                      batch_tokens: int, aux: Dict[str, Any], fwd: list):
        ms = aux["moe_stats"].to(torch.float64).cpu().numpy()
        fwd_s = self._done(fwd)           # the forward's outputs are here
        scal = torch.stack([aux[k].to(torch.float32) for k in
                            ("ib_global", "fp4_ranks", "gate_open",
                             "drop_frac", "split_frac")]).cpu().tolist()
        load_sum, vis_sum = float(ms[:, 0].sum()), float(ms[:, 1].sum())
        mig_bytes, mig_s, mig_hidden = self._pending_migration
        self._pending_migration = (0, 0.0, 0.0)
        stat = IterStats(
            n_active=n_active, tokens=tokens,
            ib_global=scal[0] / self._n_moe,
            fp4_ranks=scal[1] / self._n_moe,
            gate_open=scal[2] / self._n_moe,
            phase=phase, t_wall=self.clock(), batch_tokens=batch_tokens,
            vis_frac=vis_sum / max(load_sum, 1.0),
            drop_frac=scal[3] / self._n_moe,
            migration_bytes=mig_bytes, migration_s=mig_s,
            migration_hidden_s=mig_hidden,
            split_frac=scal[4] / self._n_moe)
        es = ss = None
        if self._placement is not None:
            es = aux["expert_stats"].to(torch.float64).cpu().numpy()
            ss = aux["slot_stats"].to(torch.float64).cpu().numpy()
        if self._elastic is not None and self._elastic.recovering:
            stat.n_unroutable = int(self._elastic.lost_experts.size)
            stat.lost_tokens = self._elastic.lost_token_count(es)
        self.stats.append(stat)
        gate = getattr(self._placement, "cost_gate", None)
        t_gate = stat.t_wall
        if self._mesh is not None and (self.profiler.enabled or hasattr(
                gate, "observe_iter")):
            # the seconds a cost gate prices replans with (its own and the
            # profiler's drift EWMA) come from each rank's clock: agreed,
            # so that every rank stages the same plans
            t_gate, fwd_s = ep_moe._dist_comm(self._mesh).agree_max(
                [t_gate, fwd_s])
        if self._placement is not None:
            # [n_blocks, 2, E] per-block expert loads -> predictor (decode
            # iterations feed the decode window when one is configured)
            self._placement.observe(es, decode=(phase == "decode"))
            if hasattr(self._placement, "observe_slots"):
                # [n_blocks, 2, S] post-split slot loads -> utilization
                self._placement.observe_slots(ss)
            if gate is not None and hasattr(gate, "observe_iter"):
                gate.observe_iter(tokens, t_gate)
            if self.telemetry is not None \
                    and hasattr(self._placement, "rank_heatmap"):
                # realized [n_blocks, ep] rank loads under the routable
                # tables -> heatmap + prediction accuracy
                self.telemetry.record_rank_heatmap(
                    self._placement.rank_heatmap(es, ss))
        if self.telemetry is not None:
            self.telemetry.record_iter(stat)
        if self.profiler.enabled:
            # the FLOP/byte ledger and the drift EWMA off the stats already
            # on the host; fwd_s is this forward's engine-clock seconds,
            # from its start to its statistics on the host
            self.profiler.observe_iter(
                moe_stats=ms, fp4_layers=stat.fp4_ranks, tokens=tokens,
                batch_tokens=batch_tokens, fwd_s=fwd_s, phase=phase)
        trc = self.tracer
        if trc.enabled:
            trc.instant("dispatch.policy", cat="policy",
                        args={"it": self._it, "phase": phase,
                              "tokens": tokens,
                              "ib_global": stat.ib_global,
                              "fp4_ranks": stat.fp4_ranks,
                              "gate_open": stat.gate_open,
                              "drop_frac": stat.drop_frac})

    def _finish(self, req: Request):
        req.finish_time = self.clock()
        if self.telemetry is not None:
            self.telemetry.record_request(req)

    def _first_token(self, req: Request, tok: int):
        req.generated.append(tok)
        req.first_token_time = self.clock()
        self.pos[req.slot] = req.prompt_len
        self.last_tok[req.slot] = tok
        self.decode_ready[req.slot] = True
        if req.done:
            self._finish(req)

    # -- prefill ---------------------------------------------------------------
    def _insert_cache(self, slot: int, new_cache):
        """Copy a batch-1 prefill cache into slot ``slot`` of the engine
        cache, in place, every entry of every layer (KV rows, Mamba
        states, the memory's K/V).  Stacked block entries are [n_blocks,
        B, ...] (batch axis 1); prefix entries are [B, ...] (axis 0).  In
        the tensor-parallel layout each rank holds a slice of both: a
        batch of one leaves more axes to the prefill cache's rows than the
        engine's batch leaves to its own, so those rows are gathered
        whole (every rank takes part) and cut as the engine's cache is;
        the data row holding the slot writes it."""
        mesh = self._mesh
        cut = None
        rows = slice(0, self.max_slots)
        if mesh is not None and tensor_parallel(mesh):
            src_kv = tf.kv_layout(mesh, 1, self.max_len)
            dst_kv = tf.kv_layout(mesh, self.max_slots, self.max_len)
            if src_kv[0] != dst_kv[0]:
                cut = (src_kv[0], dst_kv)
            rows = local_slice(self.max_slots, "batch", mesh)
        comm = None if cut is None else ep_moe._dist_comm(mesh)
        for group, axis in (("blocks", 1), ("prefix", 0)):
            for name, entries in self.cache.get(group, {}).items():
                for n, t in entries.items():
                    src = new_cache[group][name][n]
                    if cut is not None and n in ("k", "v", "latent",
                                                 "k_rope"):
                        whole = comm._whole(src.contiguous(), axis + 1,
                                            cut[0], "cache_all_gather")
                        src = whole.narrow(axis + 1, cut[1][1], cut[1][2])
                    if rows.start <= slot < rows.stop:
                        t.narrow(axis, slot - rows.start, 1).copy_(src)

    def _prefill_oneshot(self, req: Request):
        """The whole prompt in one batch-1 forward, its cache copied into
        the request's slot (with its vision embeds, if any; an
        encoder-decoder's encoder runs on them, or on zeros)."""
        dt = DTYPES[self.cfg.param_dtype]
        batch = {"tokens": self._tensor(req.tokens, torch.int32)[None],
                 "modality": self._tensor(req.modality, torch.bool)[None]}
        if req.vision_embeds is not None:
            batch["vision_embeds"] = self._tensor(req.vision_embeds, dt)[None]
        if self.cfg.is_encdec:
            batch["enc_embeds"] = self._tensor(
                req.vision_embeds if req.vision_embeds is not None
                else np.zeros((self.cfg.enc_seq_len, self.cfg.d_model),
                              np.float32), dt)[None]
        fwd = self._begin("prefill")
        res = self._counted["prefill"](self.params, self.cfg, self.rcfg,
                                       batch, self.m_state,
                                       cache_len=self.max_len,
                                       placement=self._place_args())
        self.m_state.copy_(res.m_state)
        self._tick(req.prompt_len)
        fwd[3] = {"tokens": req.prompt_len}
        self._insert_cache(req.slot, res.cache)
        req.prefill_pos = req.prompt_len
        self._first_token(req, int(self._sample(res.logits)[0]))
        self._record(phase="prefill", n_active=1, tokens=req.prompt_len,
                     batch_tokens=req.prompt_len, aux=res.aux, fwd=fwd)

    def _plan_chunks(self) -> List:
        """Allocate the token budget over slots with pending prefill work,
        oldest admission first; at most one partial chunk per iteration."""
        budget = self.prefill_budget
        plan = []
        for slot in self._prefill_fifo:
            if budget <= 0:
                break
            req = self.scheduler.active[slot]
            take = min(req.prompt_len - req.prefill_pos, budget)
            plan.append((slot, take))
            budget -= take
        return plan

    def _chunk_prefill_step(self) -> int:
        plan = self._plan_chunks()
        if not plan:
            return 0
        s_bucket = _bucket(max(take for _, take in plan))
        b = self.max_slots
        tokens = np.zeros((b, s_bucket), np.int32)
        modality = np.zeros((b, s_bucket), bool)
        start = np.zeros(b, np.int32)
        chunk_len = np.zeros(b, np.int32)
        for slot, take in plan:
            req = self.scheduler.active[slot]
            p0 = req.prefill_pos
            tokens[slot, :take] = req.tokens[p0:p0 + take]
            modality[slot, :take] = req.modality[p0:p0 + take]
            start[slot] = p0
            chunk_len[slot] = take
        fwd = self._begin("chunk")
        logits, aux = self._forward("chunk", {
            "tokens": tokens, "start": start, "chunk_len": chunk_len,
            "modality": modality})
        self._tick(b * s_bucket)
        fwd[3] = {"slots": len(plan), "batch_tokens": b * s_bucket}
        completing = [slot for slot, take in plan
                      if self.scheduler.active[slot].prefill_pos + take
                      >= self.scheduler.active[slot].prompt_len]
        toks = self._sample(logits) if completing else None
        n_tok = 0
        for slot, take in plan:
            req = self.scheduler.active[slot]
            req.prefill_pos += take
            n_tok += take
            if req.prefill_pos >= req.prompt_len:
                self._prefill_fifo.remove(slot)
                self._first_token(req, int(toks[slot]))
        self._record(phase="prefill", n_active=len(plan), tokens=n_tok,
                     batch_tokens=b * s_bucket, aux=aux, fwd=fwd)
        return n_tok

    # -- the iteration --------------------------------------------------------
    def step(self) -> int:
        """One continuous-batching iteration. Returns #active sequences."""
        trc = self.tracer
        if not trc.enabled:
            return self._step()
        with trc.span("iter", cat="engine") as sp:
            n = self._step()
            sp.set(it=self._it, n_active=n, **self.profiler.span_args())
        return n

    def _step(self) -> int:
        self._it += 1
        # scripted rank faults fire between iterations, the event boundary
        # of elastic serving (tables, params and plans are quiescent)
        if self._fault is not None:
            for ev in self._fault.due(self._it):
                if ev.kind == "fail":
                    self.fail_rank(ev.rank)
                else:
                    self.rejoin_rank(ev.rank)
        # weighted token splitting re-derives its per-replica schedule at
        # the manager's cadence — a table refresh, no weights move
        if self._placement is not None and \
                getattr(self._placement, "wants_table_refresh",
                        lambda it: False)(self._it):
            self._place_stale = True
        # a due replan lands before any forward of this iteration sees the
        # weights; then the replica-aware capacity follows the prediction
        self._maybe_migrate()
        if self._placement is not None:
            self._maybe_resize_capacity()
        # everything up to here is the between-iteration window (faults,
        # migrations, resizes); the rest is the hot loop the sentinel
        # guards against unsanctioned device->host syncs
        with self.sentinel.hot("iter"):
            return self._step_hot()

    def _step_hot(self) -> int:
        # the overlap window of the async budget starts after the
        # migration charges: it sizes against forward compute only
        t_step0 = self.clock()
        # 0) purge slots freed by a mid-prefill retirement
        if self._prefill_fifo:
            self._prefill_fifo = [s for s in self._prefill_fifo
                                  if s in self.scheduler.active]
        # 1) admit new requests; route each to the chunked or one-shot path
        with self.tracer.span("admit", cat="engine") as sp:
            n_admitted = 0
            for req in self.scheduler.admit():
                n_admitted += 1
                self.active_mask[req.slot] = True
                self.decode_ready[req.slot] = False
                self.mod_state[req.slot] = req.decode_modality
                if self.chunked and req.vision_embeds is None:
                    req.prefill_pos = 0
                    self._prefill_fifo.append(req.slot)
                else:
                    self._prefill_oneshot(req)
            if self.tracer.enabled:
                sp.set(admitted=n_admitted)

        # 2) one batched chunk of prefill work across all pending slots
        if self._prefill_fifo:
            self._chunk_prefill_step()

        self.scheduler.retire()
        for s in range(self.max_slots):
            self.active_mask[s] = s in self.scheduler.active
            if not self.active_mask[s]:
                self.decode_ready[s] = False
        if not self.scheduler.active:
            self._observe_iter_s(t_step0)
            return 0

        # 3) batched decode over decode-ready slots (others run dummies whose
        # cache writes land out of range and are dropped)
        ready = self.decode_ready & self.active_mask
        n_active = 0
        if ready.any():
            arrays = {
                "tokens": self.last_tok[:, None].astype(np.int32),
                "pos": np.where(ready, self.pos, self.max_len)
                .astype(np.int32),
                "modality": np.where(ready, self.mod_state, False)[:, None],
                "valid": ready[:, None].copy()}
            fwd = self._begin("decode")
            logits, aux = self._forward("decode", arrays)
            self._tick(self.max_slots)
            fwd[3] = {"batch_tokens": self.max_slots,
                      "ready": int(ready.sum())}
            toks = self._sample(logits)
            for slot, req in list(self.scheduler.active.items()):
                if ready[slot] and not req.done:
                    req.generated.append(int(toks[slot]))
                    self.last_tok[slot] = int(toks[slot])
                    self.pos[slot] += 1
                    n_active += 1
                    if req.done:
                        self._finish(req)
            self._record(phase="decode", n_active=n_active, tokens=n_active,
                         batch_tokens=self.max_slots, aux=aux, fwd=fwd)
        self.scheduler.retire()
        self._observe_iter_s(t_step0)
        return max(n_active, len(self._prefill_fifo))

    def _observe_iter_s(self, t_step0: float):
        """EWMA of one iteration's seconds on the engine clock (virtual
        charges or wall time alike) — the overlap window the async
        migration budget sizes its chunk batches against."""
        dt = self.clock() - t_step0
        if dt <= 0:
            return
        self._iter_s = dt if self._iter_s is None \
            else 0.75 * self._iter_s + 0.25 * dt

    def run(self, max_iters: int = 10_000) -> List[Request]:
        it = 0
        while not self.scheduler.idle and it < max_iters:
            self.step()
            it += 1
        return self.scheduler.finished

    # -- checkpointing --------------------------------------------------------
    def save_checkpoint(self, ckpt_dir: str, step: int, keep: int = 3) -> str:
        """Persist params and the AIMD state (group ``serving``), and the
        manager's tables and predictor under its own group (``placement``
        or ``replication``), in the reference's format, so a restored
        engine resumes with the layout its saved weights are in.

        Refused while a plan is in flight: the params then hold a mix of
        landed and not-yet-landed slabs that no saved table describes —
        call :meth:`drain_migrations` first.  Under a mesh every rank
        calls it; the checkpoint holds the global layout, equal to what a
        one-device engine with the same tables writes, and rank 0 writes
        it."""
        self._refuse_mid_flight("save")
        state = {"serving": {"params": self.params, "m_state": self.m_state}}
        if self._placement is not None:
            state[self._placement.ckpt_group] = self._placement.state_dict()
        return ckpt.save(ckpt_dir, step, state, keep=keep, mesh=self._mesh,
                         spec=self._ckpt_spec())

    def _ckpt_spec(self):
        """The declarations the checkpoint cuts the params by in the
        tensor-parallel layout (None: the EP-only layout): the expert
        stacks at the ``S`` physical slots the manager routes over (a
        replica engine's spares included)."""
        if self._mesh is None or not tensor_parallel(self._mesh):
            return None
        n_slots = None if self._placement is None or self.cfg.moe is None \
            else tf.n_physical_slots(self.cfg,
                                     self._placement.device_tables())
        return {"params": tf.model_spec(self.cfg, n_slots)}

    def _refuse_mid_flight(self, what: str) -> None:
        if self.migration_draining \
                or getattr(self._placement, "in_flight", None) is not None:
            raise RuntimeError(
                f"cannot {what} a checkpoint while a migration is "
                "draining (params hold a partially-landed slab layout); "
                "call drain_migrations() first")
        if self._elastic is not None and self._elastic.recovering:
            raise RuntimeError(
                f"cannot {what} a checkpoint mid-recovery (params hold "
                "zeroed slabs for unroutable experts a restore would "
                "resurrect); let the recovery plan land first")

    def load_checkpoint(self, ckpt_dir: str,
                        step: Optional[int] = None) -> int:
        """Restore params, the AIMD state and the manager's state onto this
        engine's device.  The saved weights are in the writer's layout: a
        checkpoint of a placement engine holds them permuted by its tables,
        one of a replication engine in its ``S`` replica slots.  A reader
        of another manager kind (or none) is refused, as the reference
        refuses it; a manager reading a manager-free checkpoint resets to
        its identity state (a replica manager re-expands the logical rows
        into its slots).  Under a mesh each rank reads its own slots of
        the global checkpoint."""
        self._refuse_mid_flight("load")
        step = ckpt.latest_step(ckpt_dir) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        own = None if self._placement is None \
            else self._placement.ckpt_group
        for name, kind in (("placement", "a placement engine"),
                           ("replication", "a replication engine")):
            if name != own and ckpt.has_group(ckpt_dir, name, step):
                raise ValueError(
                    f"checkpoint {ckpt_dir} step {step} was written by "
                    f"{kind} (weights are in its placed physical order); "
                    "construct this Engine with the matching manager to "
                    "restore it")
        state = None
        if own is not None and ckpt.has_group(ckpt_dir, own, step):
            state = ckpt.restore_group(ckpt_dir, own, step)
        # the template gives structure and devices; shapes are the saved
        # ones (a manager-free checkpoint has one row per logical expert)
        templates = {"serving": {"params": self.params,
                                 "m_state": self.m_state}}
        step, out = ckpt.restore(ckpt_dir, templates, step, mesh=self._mesh,
                                 spec=self._ckpt_spec())
        self.params = out["serving"]["params"]
        self.m_state.copy_(out["serving"]["m_state"])
        if self._placement is not None:
            if state is None:
                self._placement.reset()
                if own == "replication":
                    self.params = rmigrate.expand_moe_params(
                        self.params, self._placement.rsets)
            else:
                self._placement.load_state_dict(state)
            self._place_stale = True
        return step


def _entry(name: str):
    """The model's ``<name>_forward``, looked up when called."""
    def forward(*args, **kwargs):
        return getattr(tf, f"{name}_forward")(*args, **kwargs)
    forward.__name__ = f"{name}_forward"
    return forward


def sample_tokens(logits: torch.Tensor, temperature: float,
                  generator: torch.Generator) -> torch.Tensor:
    """One token per row of ``logits [B, V]``: the first maximum (as
    ``jnp.argmax``) when ``temperature <= 0``, else a draw from
    ``softmax(logits / temperature)`` by the Gumbel-max trick, as
    ``jax.random.categorical`` draws, with noise from ``generator``."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits.to(torch.float32) / temperature + gumbel,
                        dim=-1)

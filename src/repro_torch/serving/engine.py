"""Batched serving engine of the port: chunked token-budgeted prefill,
one-shot prefill and batched decode with ReaLB active, with expert
placement or replication and live migration.

Counterpart of ``repro.serving.engine.Engine`` on one device, without
elastic serving, the profiler and the sentinel (their ``None`` defaults
bypass them in the reference too).  The engine holds one device-resident KV
cache of ``max_slots`` sequences.  Each iteration packs up to
``prefill_budget`` prompt tokens across every slot with pending prefill
work into one ``[max_slots, bucket]`` chunk forward, then runs one batched
decode step over the decode-ready slots.  A request that carries
``vision_embeds``, or every request when ``prefill_budget=0``, is
prefilled whole in a batch-1 ``prefill_forward`` at admission and its
cache copied into its slot.  The AIMD ``m_state`` of ReaLB persists across
iterations; per-iteration routing stats are kept in ``self.stats`` and fed,
with every finished request, to an optional
:class:`~repro_torch.serving.telemetry.Telemetry`.  ``virtual_ep`` sizes
the policy's virtual EP topology.  ``temperature > 0`` samples from
``softmax(logits / temperature)`` on the device with a ``torch.Generator``
seeded by ``seed`` (JAX's PRNG draws are not reproduced); 0 is greedy.
``save_checkpoint``/``load_checkpoint`` write and read the reference's
format.

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
The device tables are uploaded once per committed change (or weighted-split
refresh), so no forward uploads them.  ``capacity_margin`` lets a replica
manager shrink the dispatch capacity to its post-split predicted peak.
Migration bytes and seconds are charged to the clock and reported in the
next :class:`IterStats`; spans go to ``tracer``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig, ReaLBConfig
from repro_torch.core import ep_moe
from repro_torch.core.policy import init_m_state
from repro_torch.models import transformer as tf
from repro_torch.models.common import DTYPES, resolve_device
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.placement import migrate as pmigrate
from repro_torch.replication import migrate as rmigrate
from repro_torch.serving.async_migrate import MigrationExecutor
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
    #                              (0: elastic serving is not ported)
    lost_tokens: float = 0.0     # tokens routed to an unroutable expert


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
                 device=None):
        if elastic is not None or fault_injector is not None:
            raise NotImplementedError(
                "elastic serving (elastic=, fault_injector=) is not ported "
                "yet: it is the next slice of the port, ROADMAP Queue A "
                "item 5 (serving/elastic.py, runtime/elastic.py)")
        self.device = resolve_device(device)
        self.cfg, self.params, self.rcfg = cfg, params, rcfg
        # span tracer; None -> the shared no-op singleton.  Shared with the
        # manager so its replan spans land on the same timeline.
        self.tracer = NULL_TRACER if tracer is None else tracer
        if tracer is not None and placement is not None:
            placement.tracer = tracer
        self.max_slots, self.max_len = max_slots, max_len
        self.temperature = temperature
        self.prefill_budget = prefill_budget
        # chunk continuation needs a plain GQA/MQA decoder stack
        self.chunked = (prefill_budget > 0 and cfg.layer_pattern == "attn"
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
            want = int(tables[2].shape[-1]) if len(tables) >= 3 \
                else cfg.moe.num_experts
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
        self._place_cache = None                  # device copy of the table
        self._it = 0
        self.cache = tf.init_cache(cfg, max_slots, max_len, self.device)
        self.m_state = init_m_state(*ep_moe.moe_state_shape(virtual_ep),
                                    rcfg, device=self.device)
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

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _place_args(self):
        """The device tables of the routable plan — (e2r, local_slot) for a
        placement manager, (rep_pos, n_rep, slot_owner[, split_sched]) for
        a replica manager, None without one.  Uploaded once and cached
        until a commit or a weighted-split refresh changes them, so no
        forward uploads a table."""
        if self._placement is None:
            return None
        if self._place_cache is None:
            self._place_cache = tuple(
                self._tensor(a) for a in self._placement.device_tables())
        return self._place_cache

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
            self._mig = MigrationExecutor(
                self._placement, plan,
                bytes_per_iter=self.migrate_bytes_per_iter,
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
        wall = time.perf_counter() - t0
        self._placement.bandwidth.observe(plan.moved_bytes, wall)
        layers = self._placement.plan_layers(plan)
        # staged plans become routable only after the slabs landed
        self._placement.commit(plan)
        self._place_cache = None                  # table changed
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

    def _drain_migration(self):
        """One budgeted chunk batch of the in-flight plan: land the
        slabs, commit exactly those layers, split the transfer seconds
        into hidden (fits the budget — overlapped with this iteration's
        forward) and stall (the excess, charged to a virtual clock)."""
        try:
            self.params, rep = self._mig.drain(self.params, self._iter_s)
        except BaseException:
            # the executor aborted the staged remainder; layers committed
            # by earlier batches stay routable (their slabs did land)
            self._mig = None
            self._place_cache = None
            raise
        self._place_cache = None              # landed layers' tables flipped
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
        self._place_cache = None

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

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request):
        if req.prompt_len + req.max_new_tokens > self.max_len:
            raise ValueError(f"request needs {req.prompt_len} + "
                             f"{req.max_new_tokens} > max_len {self.max_len}")
        if req.arrival_time is None:
            req.arrival_time = self.clock()
        self.scheduler.submit(req)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """The next token of every row, drawn on the device; pulling it is
        the one host read that serving requires."""
        return sample_tokens(logits, self.temperature, self._gen) \
            .to(torch.int32).cpu().numpy()

    def _tick(self, batch_tokens: int):
        """Advance a virtual clock by the modeled cost of one forward."""
        if self.cost_model is not None and hasattr(self.clock, "advance"):
            self.clock.advance(self.cost_model.cost(batch_tokens))

    def _record(self, *, phase: str, n_active: int, tokens: int,
                batch_tokens: int, aux: Dict[str, Any]):
        """Pull the iteration's stats to the host (with the sampled tokens,
        the host reads serving makes, all after the forward), record them
        and feed the manager."""
        ms = aux["moe_stats"].to(torch.float64).cpu().numpy()
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
        self.stats.append(stat)
        if self._placement is not None:
            # [n_blocks, 2, E] per-block expert loads -> predictor (decode
            # iterations feed the decode window when one is configured)
            es = aux["expert_stats"].to(torch.float64).cpu().numpy()
            ss = aux["slot_stats"].to(torch.float64).cpu().numpy()
            self._placement.observe(es, decode=(phase == "decode"))
            if hasattr(self._placement, "observe_slots"):
                # [n_blocks, 2, S] post-split slot loads -> utilization
                self._placement.observe_slots(ss)
            gate = getattr(self._placement, "cost_gate", None)
            if gate is not None and hasattr(gate, "observe_iter"):
                gate.observe_iter(tokens, stat.t_wall)
            if self.telemetry is not None \
                    and hasattr(self._placement, "rank_heatmap"):
                # realized [n_blocks, ep] rank loads under the routable
                # tables -> heatmap + prediction accuracy
                self.telemetry.record_rank_heatmap(
                    self._placement.rank_heatmap(es, ss))
        if self.telemetry is not None:
            self.telemetry.record_iter(stat)
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
        cache, in place.  Stacked block entries are [n_blocks, B, ...]
        (batch axis 1); prefix entries are [B, ...] (axis 0)."""
        for group, axis in (("blocks", 1), ("prefix", 0)):
            for name, kv in self.cache.get(group, {}).items():
                for n in ("k", "v"):
                    kv[n].narrow(axis, slot, 1).copy_(new_cache[group][name][n])

    def _prefill_oneshot(self, req: Request):
        """The whole prompt in one batch-1 forward, its cache copied into
        the request's slot (with its vision embeds, if any)."""
        batch = {"tokens": self._tensor(req.tokens, torch.int32)[None],
                 "modality": self._tensor(req.modality, torch.bool)[None]}
        if req.vision_embeds is not None:
            batch["vision_embeds"] = self._tensor(
                req.vision_embeds, DTYPES[self.cfg.param_dtype])[None]
        with self.tracer.span("forward.prefill", cat="forward") as sp:
            res = tf.prefill_forward(self.params, self.cfg, self.rcfg, batch,
                                     self.m_state, cache_len=self.max_len,
                                     placement=self._place_args())
            self.m_state = res.m_state
            self._tick(req.prompt_len)
            if self.tracer.enabled:
                sp.set(tokens=req.prompt_len)
        self._insert_cache(req.slot, res.cache)
        req.prefill_pos = req.prompt_len
        self._first_token(req, int(self._sample(res.logits)[0]))
        self._record(phase="prefill", n_active=1, tokens=req.prompt_len,
                     batch_tokens=req.prompt_len, aux=res.aux)

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
        batch = {"tokens": self._tensor(tokens), "start": self._tensor(start),
                 "chunk_len": self._tensor(chunk_len),
                 "modality": self._tensor(modality)}
        with self.tracer.span("forward.chunk", cat="forward") as sp:
            res = tf.chunk_forward(self.params, self.cfg, self.rcfg, batch,
                                   self.cache, self.m_state,
                                   placement=self._place_args())
            self.cache, self.m_state = res.cache, res.m_state
            self._tick(b * s_bucket)
            if self.tracer.enabled:
                sp.set(slots=len(plan), batch_tokens=b * s_bucket)
        completing = [slot for slot, take in plan
                      if self.scheduler.active[slot].prefill_pos + take
                      >= self.scheduler.active[slot].prompt_len]
        toks = self._sample(res.logits) if completing else None
        n_tok = 0
        for slot, take in plan:
            req = self.scheduler.active[slot]
            req.prefill_pos += take
            n_tok += take
            if req.prefill_pos >= req.prompt_len:
                self._prefill_fifo.remove(slot)
                self._first_token(req, int(toks[slot]))
        self._record(phase="prefill", n_active=len(plan), tokens=n_tok,
                     batch_tokens=b * s_bucket, aux=res.aux)
        return n_tok

    # -- the iteration --------------------------------------------------------
    def step(self) -> int:
        """One continuous-batching iteration. Returns #active sequences."""
        trc = self.tracer
        if not trc.enabled:
            return self._step()
        with trc.span("iter", cat="engine") as sp:
            n = self._step()
            sp.set(it=self._it, n_active=n)
        return n

    def _step(self) -> int:
        self._it += 1
        # weighted token splitting re-derives its per-replica schedule at
        # the manager's cadence — a table refresh, no weights move
        if self._placement is not None and \
                getattr(self._placement, "wants_table_refresh",
                        lambda it: False)(self._it):
            self._place_cache = None
        # a due replan lands before any forward of this iteration sees the
        # weights; then the replica-aware capacity follows the prediction
        self._maybe_migrate()
        if self._placement is not None:
            self._maybe_resize_capacity()
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
            batch = {
                "tokens": self._tensor(self.last_tok[:, None], torch.int32),
                "pos": self._tensor(np.where(ready, self.pos, self.max_len),
                                    torch.int32),
                "modality": self._tensor(
                    np.where(ready, self.mod_state, False)[:, None]),
                "valid": self._tensor(ready[:, None])}
            with self.tracer.span("forward.decode", cat="forward") as sp:
                res = tf.decode_forward(self.params, self.cfg, self.rcfg,
                                        batch, self.cache, self.m_state,
                                        placement=self._place_args())
                self.cache, self.m_state = res.cache, res.m_state
                self._tick(self.max_slots)
                if self.tracer.enabled:
                    sp.set(batch_tokens=self.max_slots,
                           ready=int(ready.sum()))
            toks = self._sample(res.logits)
            for slot, req in list(self.scheduler.active.items()):
                if ready[slot] and not req.done:
                    req.generated.append(int(toks[slot]))
                    self.last_tok[slot] = int(toks[slot])
                    self.pos[slot] += 1
                    n_active += 1
                    if req.done:
                        self._finish(req)
            self._record(phase="decode", n_active=n_active, tokens=n_active,
                         batch_tokens=self.max_slots, aux=res.aux)
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
        call :meth:`drain_migrations` first."""
        self._refuse_mid_flight("save")
        state = {"serving": {"params": self.params, "m_state": self.m_state}}
        if self._placement is not None:
            state[self._placement.ckpt_group] = self._placement.state_dict()
        return ckpt.save(ckpt_dir, step, state, keep=keep)

    def _refuse_mid_flight(self, what: str) -> None:
        if self.migration_draining \
                or getattr(self._placement, "in_flight", None) is not None:
            raise RuntimeError(
                f"cannot {what} a checkpoint while a migration is "
                "draining (params hold a partially-landed slab layout); "
                "call drain_migrations() first")

    def load_checkpoint(self, ckpt_dir: str,
                        step: Optional[int] = None) -> int:
        """Restore params, the AIMD state and the manager's state onto this
        engine's device.  The saved weights are in the writer's layout: a
        checkpoint of a placement engine holds them permuted by its tables,
        one of a replication engine in its ``S`` replica slots.  A reader
        of another manager kind (or none) is refused, as the reference
        refuses it; a manager reading a manager-free checkpoint resets to
        its identity state (a replica manager re-expands the logical rows
        into its slots)."""
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
        step, out = ckpt.restore(ckpt_dir, templates, step)
        self.params = out["serving"]["params"]
        self.m_state = out["serving"]["m_state"]
        if self._placement is not None:
            if state is None:
                self._placement.reset()
                if own == "replication":
                    self.params = rmigrate.expand_moe_params(
                        self.params, self._placement.rsets)
            else:
                self._placement.load_state_dict(state)
            self._place_cache = None
        return step


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

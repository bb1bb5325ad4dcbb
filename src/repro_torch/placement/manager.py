"""PlacementManager: the serving-side control loop of the subsystem.

Owns the current placement tables, the EWMA predictor and the replan
cadence.  The engine feeds it per-iteration expert stats (`observe`),
asks it every iteration whether a replan is due (`maybe_replan` → a
*staged* migration plan or None) and applies the returned weight
permutation itself (the manager never touches device arrays) before
committing — the whole plan at once (`commit`), or layer by layer as
each slab lands under async overlapped migration (`commit_layers`, see
``repro_torch.serving.async_migrate``).  Until commit the old tables stay
routable, and no further replan can fire.  Cumulative migration
accounting lives here so telemetry and benchmarks can report the
placement-vs-ReaLB overhead trade-off directly; a measured-bandwidth
EWMA (``bandwidth``) prices the transfers once the engine has timed
real applies; under a mesh it observes seconds agreed over the ranks, so
every rank prices, gates and packs a migration alike.

Per-layer tables (``PlacementConfig.per_layer``): one table per scanned
MoE block instead of one shared table.  The predictor's per-layer state
stops being summed away — each layer is planned independently from its
own EWMA row (MoE-GPS: prediction granularity decides the gains) — and
migration becomes a *layer-diff*: only layers whose plan changed move
weight slabs (HarMoEny-style layer-wise rebalancing), so migration
traffic scales with the number of changed layers rather than
``n_layers×``.  ``device_tables`` then returns stacked ``[L, E]`` arrays
that the transformer threads through its block loop.  With ``n_tables ==
1`` everything degenerates to the shared-table behavior bitwise.

Decode-regime replanning: with ``decode_halflife`` the predictor keeps a
separate decode window, and ``decode_replan_every`` arms an additional
cadence counted in *decode* iterations that plans from that window — so
decode-regime drift is not drowned by prefill-dominated statistics.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.configs.base import ModelConfig, PlacementConfig
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.placement import migrate
from repro_torch.placement.planner import plan_placement
from repro_torch.placement.predictor import EWMAPredictor
from repro_torch.placement.table import PlacementTable

Plan = Union[migrate.MigrationPlan, migrate.LayerMigrationPlan]


class ReplanDiscipline:
    """Replan cadence + decode-window + cost-gate + staged-commit
    discipline shared by :class:`PlacementManager` and
    :class:`~repro_torch.replication.manager.ReplicaManager` — their configs
    carry the same ``enabled`` / ``replan_every`` / ``warmup_iters`` /
    ``decode_replan_every`` fields.  Hosts the manager-agnostic half of
    ``maybe_replan`` so the two control loops cannot drift apart.

    Staged commit: every plan returned by ``maybe_replan`` is *pending*
    — the routable tables (``device_tables``) are unchanged until the
    engine has landed the weight slabs and calls :meth:`commit` (whole
    plan, the synchronous path) or :meth:`commit_layers` (one chunk of
    layers at a time, the async path — each layer's table flips
    independently as its slab lands).  While a plan is in flight
    ``maybe_replan`` is a guarded no-op: a second replan overwriting the
    staged plan would desynchronize the commit protocol (the engine
    would gather slabs for one plan and flip tables for another).
    :meth:`abort` drops the pending plan — the old tables stay routable
    and consistent with the untouched weights — which is also the
    supersede path: abort, then let the next cadence point re-plan from
    fresher statistics."""

    # filled in by the concrete manager's _setup
    predictor: EWMAPredictor
    cost_gate = None
    last_replan_iter = -1
    _decode_since_replan = 0
    _pending = None                 # staged plan awaiting its slabs
    _pending_remaining = None       # chunk (layer) indices not yet landed
    _event_replan = False           # a requested event-triggered replan
    _event_now = False              # the current attempt IS event-triggered
    must_layers = frozenset()       # layers that must replan regardless of
    #                                 gain (elastic recovery: lost experts)
    # observability (opt-in, both default to inert singletons/None):
    # every maybe_replan call ends in exactly one audit verdict; planning
    # attempts past the cadence gate get a tracer span
    audit = None                    # the reference's ReplanAudit interface
    tracer = NULL_TRACER            # repro_torch.obs.trace.Tracer
    _kind = "manager"               # audit/span label: placement|replication
    _skip = None                    # why the last _cadence said no
    _verdict = "no-cadence"         # the last maybe_replan verdict
    _verdict_fields: dict = {}

    def _discipline_cfg(self):
        """The PlacementConfig / ReplicationConfig of the manager."""
        raise NotImplementedError

    def _replan_blocked(self) -> bool:
        """Manager-specific extra guard (e.g. the identity planner)."""
        return False

    def request_replan(self) -> None:
        """Arm an event-triggered replan (elastic rank loss/rejoin): the
        next ``maybe_replan`` fires immediately — bypassing the cadence,
        the ``min_gain`` churn guard and the cost gate — as soon as no
        plan is in flight and the predictor has any observation.  The
        request is sticky until consumed."""
        self._event_replan = True

    def _cadence(self, it: int) -> Optional[str]:
        """The prediction regime a replan at ``it`` should plan from, or
        None when no cadence is due (``_skip`` then names the reason for
        the audit log)."""
        p = self._discipline_cfg()
        self._event_now = False
        self._skip = None
        if not p.enabled:
            self._skip = "disabled"
            return None
        if self._pending is not None:
            self._skip = "in-flight"
            return None
        if self._replan_blocked():
            self._skip = "blocked"
            return None
        if self._event_replan and self.predictor.n_obs > 0:
            self._event_replan = False
            self._event_now = True
            return "mixed"
        if self.predictor.n_obs < p.warmup_iters:
            self._skip = "warmup"
            return None
        if it == self.last_replan_iter:
            self._skip = "already-replanned"
            return None
        if p.replan_every > 0 and it % p.replan_every == 0:
            return "mixed"
        if (p.decode_replan_every > 0
                and self._decode_since_replan >= p.decode_replan_every
                and self.predictor.n_obs_decode > 0):
            # the decode cadence point fires exactly once: reset the
            # counter even when the attempt is later rejected (min_gain /
            # noop / cost gate), so a rejected plan does not re-run the
            # full planner on every subsequent iteration
            self._decode_since_replan = 0
            return "decode"
        self._skip = "no-cadence"
        return None

    def _gate_accept(self, old_loads: np.ndarray, new_loads: np.ndarray,
                     n_moved: int) -> bool:
        """old/new_loads: [ep] for shared, [L, ep] stacks for per-layer."""
        if self.cost_gate is None:
            return True
        if old_loads.ndim == 2:
            if hasattr(self.cost_gate, "accept_layers"):
                return self.cost_gate.accept_layers(old_loads, new_loads,
                                                    n_moved)
            old_loads, new_loads = old_loads.sum(0), new_loads.sum(0)
        return self.cost_gate.accept(old_loads, new_loads, n_moved)

    # -- decision audit / tracing -----------------------------------------
    def _decide(self, verdict: str, **fields):
        """Record the verdict of the current planning attempt; returns
        None so rejection paths read ``return self._decide(...)``."""
        self._verdict = verdict
        self._verdict_fields = fields
        return None

    def plan_bytes(self, plan) -> int:
        """Total transfer bytes of a staged plan (sum of its chunks)."""
        return sum(self.layer_bytes(plan, l) for l in self.plan_layers(plan))

    def maybe_replan(self, it: int):
        """Stage the migration plan to apply at iteration ``it``, or None.

        The returned plan is *pending*: the routable table(s) and the
        migration accounting are unchanged until :meth:`commit` /
        :meth:`commit_layers` — which the engine calls only after the
        slab gather landed the new weights.  Every call ends in exactly
        one audit verdict (cadence rejections included) when an audit log
        (the reference's ``ReplanAudit`` interface) is attached, and
        planning attempts past the cadence gate get a ``replan.<kind>``
        span."""
        regime = self._cadence(it)
        if regime is None:
            if self.audit is not None:
                self.audit.record(it=it, manager=self._kind,
                                  verdict=self._skip or "no-cadence")
            return None
        forced = self._event_now
        self._verdict, self._verdict_fields = "noop", {}
        trc = self.tracer
        if trc.enabled:
            with trc.span(f"replan.{self._kind}", cat="replan") as sp:
                plan = (self._replan_layers(it, regime) if self.per_layer
                        else self._replan_shared(it, regime))
                sp.set(it=it, regime=regime, verdict=self._verdict)
        else:
            plan = (self._replan_layers(it, regime) if self.per_layer
                    else self._replan_shared(it, regime))
        if self.audit is not None:
            self.audit.record(it=it, manager=self._kind,
                              verdict=self._verdict, regime=regime,
                              must=True if forced else None,
                              **self._verdict_fields)
        return plan

    def _replan_shared(self, it: int, regime: str):
        """The shared-table (``n_tables == 1``) planning attempt."""
        raise NotImplementedError

    def predicted_rank_loads(self, regime: str = "mixed"):
        """``[n_tables, ep]`` predicted per-rank loads under the current
        routable tables — the quantity the prediction-accuracy metric
        compares against realized loads per replan window.  None before
        any observation."""
        states = self._layer_states()
        pred = self.predictor.predict_layers(regime)
        if pred is not None and pred[0].shape[0] == len(states) \
                and pred[0].sum() > 0:
            loads = pred[0]
            return np.stack([s.rank_loads(loads[l])
                             for l, s in enumerate(states)])
        load, _ = self.predictor.predict(regime)
        if load.sum() <= 0:
            return None
        # shared manager under a multi-block model: one summed row
        return np.stack([s.rank_loads(load) for s in states])

    # -- staged commit (chunk = one layer of a layer-diff plan) -----------
    @property
    def in_flight(self):
        """The staged plan whose slabs have not all landed, or None."""
        return self._pending

    def plan_layers(self, plan) -> List[int]:
        """The chunk indices of a plan: changed layers of a layer-diff,
        ``[0]`` (one whole-plan chunk) for a shared plan."""
        changed = getattr(plan, "changed_layers", None)
        return [0] if changed is None else [int(l) for l in changed]

    def layer_bytes(self, plan, layer: int) -> int:
        """Transfer bytes of one chunk (manager-specific pricing)."""
        raise NotImplementedError

    def _stage(self, plan):
        assert self._pending is None, \
            "staging a plan over an in-flight one (commit or abort first)"
        self._pending = plan
        self._pending_remaining = set(self.plan_layers(plan))
        return plan

    def _commit_one_layer(self, plan, layer: int) -> None:
        """Flip one landed layer's routable table + book its bytes."""
        raise NotImplementedError

    def commit_layers(self, plan, layers) -> bool:
        """Make ``layers``' staged tables routable — call only after
        exactly those layers' weight slabs have been gathered into the
        new layout (``migrate.apply_layers_to_params``).  Returns True
        once the whole plan has landed (the migration is then counted
        and a new replan may fire)."""
        assert self._pending is plan, "commit of a plan that is not staged"
        for layer in layers:
            layer = int(layer)
            assert layer in self._pending_remaining, \
                (layer, sorted(self._pending_remaining))
            self._pending_remaining.discard(layer)
            self._commit_one_layer(plan, layer)
        if self._pending_remaining:
            return False
        self.n_migrations += 1
        self._decode_since_replan = 0
        self._pending = None
        self._pending_remaining = None
        return True

    def commit(self, plan) -> None:
        """Make the whole staged plan routable (the synchronous path —
        every slab was gathered in one ``apply_to_params``)."""
        assert self._pending is plan, "commit of a plan that is not staged"
        self.commit_layers(plan, sorted(self._pending_remaining))

    def abort(self) -> None:
        """Drop the staged plan (weights untouched for its not-yet-landed
        layers; already-committed layers stay routable — their slabs did
        land).  The old tables remain consistent with the weights."""
        self._pending = None
        self._pending_remaining = None

    # -- per-layer replan loop (hooks below are manager-specific) ---------
    def _layer_states(self) -> list:
        """Current per-layer tables / replica sets."""
        raise NotImplementedError

    def _plan_one_layer(self, load: np.ndarray, vis: np.ndarray):
        """One layer's planner call on its own [E] load row."""
        raise NotImplementedError

    def _diff_layer_states(self, old_states: list, new_states: list):
        """The layer-diff plan between two per-layer state stacks."""
        raise NotImplementedError

    def _layer_gate_moved(self, plan) -> int:
        """The move count the cost gate prices (cross-rank for replicas)."""
        return plan.n_moved

    def _accept_layer_plan(self, plan, new_states: list):
        """Adopt (placement) or stage (replication) the accepted plan."""
        raise NotImplementedError

    def _replan_layers(self, it: int, regime: str):
        """Plan each layer independently from its own EWMA row; layers
        below the churn guard keep their current state, so the diff (and
        the migration traffic) covers changed layers only.

        Churn budget (``max_changed_layers``): when set, at most that
        many layers change per replan, filled in predicted-gain order —
        an event-triggered recovery replan then cannot queue an unbounded
        migration backlog.  ``must_layers`` (elastic recovery: layers
        with unroutable experts) are exempt from both the budget and the
        ``min_gain`` guard; an event-triggered replan (``request_replan``)
        also bypasses ``min_gain`` and the cost gate for every layer."""
        pred = self.predictor.predict_layers(regime)
        if pred is None:
            return self._decide("zero-load")
        loads, viss = pred
        states = self._layer_states()
        if loads.sum() <= 0 or loads.shape[0] != len(states):
            return self._decide("zero-load")
        p = self._discipline_cfg()
        forced = self._event_now
        must = {int(l) for l in self.must_layers}
        candidates = []                        # (gain, layer, new_state)
        for l, state in enumerate(states):
            load_l, vis_l = loads[l], viss[l]
            if load_l.sum() <= 0:
                if l not in must:
                    continue
                # a recovery layer must replan even without load signal
                load_l = np.ones_like(load_l)
            new = self._plan_one_layer(load_l, vis_l)
            old_max = state.rank_loads(load_l).max()
            new_max = new.rank_loads(load_l).max()
            gain = (old_max - new_max) / old_max if old_max > 0 else 0.0
            if l in must:
                candidates.append((np.inf, l, new))
                continue
            # per-layer churn guard: strictly positive gain required
            # (a zero-gain re-permutation of one layer is pure migration
            # churn the layer-diff would otherwise ship)
            if not forced and (old_max <= 0 or gain <= p.min_gain):
                continue
            if forced and old_max <= 0:
                continue
            candidates.append((gain, l, new))
        budget = int(getattr(p, "max_changed_layers", 0))
        if budget > 0 and len(candidates) > budget:
            mandatory = [c for c in candidates if not np.isfinite(c[0])]
            optional = sorted((c for c in candidates if np.isfinite(c[0])),
                              key=lambda c: -c[0])
            candidates = mandatory \
                + optional[:max(budget - len(mandatory), 0)]
        new_states = list(states)
        for _, l, new in candidates:
            new_states[l] = new
        plan = self._diff_layer_states(states, new_states)
        if plan.is_noop:
            return self._decide("noop", changed_layers=0)
        old_rl = np.stack([s.rank_loads(loads[l])
                           for l, s in enumerate(states)])
        new_rl = np.stack([s.rank_loads(loads[l])
                           for l, s in enumerate(new_states)])
        # audit pricing: aggregate peak-load gain over the layer stack,
        # the bytes the diff would ship and their bandwidth-EWMA seconds
        old_peak = float(old_rl.max(axis=1).sum())
        new_peak = float(new_rl.max(axis=1).sum())
        nbytes = self.plan_bytes(plan)
        price = dict(
            pred_gain=(old_peak - new_peak) / old_peak
            if old_peak > 0 else 0.0,
            migration_bytes=int(nbytes),
            migration_s=float(self.migration_seconds(nbytes)),
            n_moved=int(self._layer_gate_moved(plan)),
            changed_layers=len(self.plan_layers(plan)),
            n_must_layers=len(must) if must else None)
        if not forced and not self._gate_accept(
                old_rl, new_rl, self._layer_gate_moved(plan)):
            return self._decide("cost-gate", **price)
        self.last_replan_iter = it
        self._decide("staged", **price)
        return self._accept_layer_plan(plan, new_states)


class PlacementManager(ReplanDiscipline):
    ckpt_group = "placement"       # engine checkpoint group name
    _kind = "placement"            # audit / span label

    def __init__(self, cfg: ModelConfig, pcfg: PlacementConfig, ep: int,
                 cost_gate=None):
        assert cfg.moe is not None, "placement requires an MoE model"
        n_blocks, n_moe_per_block = cfg.moe_block_structure()
        n_moe = n_blocks * n_moe_per_block
        if pcfg.per_layer:
            # one table per scanned block; a moved expert drags only that
            # block's slice of its weights
            n_tables = n_blocks
            bpe = migrate.expert_bytes(cfg, max(n_moe_per_block, 1))
        else:
            n_tables = 1
            bpe = migrate.expert_bytes(cfg, max(n_moe, 1))
        self._setup(cfg.moe.num_experts, pcfg, ep, bpe, cost_gate,
                    n_tables=n_tables)
        self.cfg = cfg

    @classmethod
    def from_geometry(cls, num_experts: int, pcfg: PlacementConfig,
                      ep: int, bytes_per_expert: int = 0,
                      cost_gate=None, n_layers: int = 1
                      ) -> "PlacementManager":
        """Model-config-free construction (cost-model simulators).

        ``bytes_per_expert`` is per-table granularity: the whole stack for
        a shared manager, one scanned block for a per-layer one."""
        self = cls.__new__(cls)
        self._setup(num_experts, pcfg, ep, bytes_per_expert, cost_gate,
                    n_tables=n_layers if pcfg.per_layer else 1)
        self.cfg = None
        return self

    def _setup(self, num_experts: int, pcfg: PlacementConfig, ep: int,
               bytes_per_expert: int, cost_gate=None, n_tables: int = 1):
        assert num_experts % ep == 0, (num_experts, ep)
        assert n_tables >= 1, n_tables
        self.pcfg, self.ep = pcfg, ep
        self.n_tables = n_tables
        self.tables: List[PlacementTable] = [
            PlacementTable.identity(num_experts, ep)
            for _ in range(n_tables)]
        self.predictor = EWMAPredictor(num_experts, alpha=pcfg.ewma_alpha,
                                       decode_halflife=pcfg.decode_halflife)
        self.bytes_per_expert = bytes_per_expert
        # optional amortized-gain guard: an object with
        # accept(old_rank_loads, new_rank_loads, n_moved) -> bool (and
        # accept_layers([L, ep] stacks) for per-layer managers), built
        # from the analytic latency model (benchmarks.costmodel.
        # ReplanCostGate) — a replan then fires only when the predicted
        # layer-time savings over its horizon exceed the migration cost
        self.cost_gate = cost_gate
        # measured-bandwidth EWMA pricing this manager's slab transfers;
        # the engine feeds it timed applies, migration_seconds and the
        # cost gate read it (single-sourced with the analytic model)
        self.bandwidth = migrate.MigrationBandwidth(pcfg.migration_bw)
        if cost_gate is not None \
                and getattr(cost_gate, "bandwidth", False) is None:
            cost_gate.bandwidth = self.bandwidth
        # cumulative accounting
        self.n_migrations = 0
        self.migrated_bytes = 0
        self.migrated_experts = 0
        self.migrated_bytes_per_layer = np.zeros(n_tables, np.int64)
        self.last_replan_iter = -1
        self._decode_since_replan = 0
        self._pending = None
        self._pending_remaining = None

    @property
    def per_layer(self) -> bool:
        return self.n_tables > 1

    @property
    def table(self) -> PlacementTable:
        """The shared table (first table of a per-layer manager)."""
        return self.tables[0]

    @table.setter
    def table(self, t: PlacementTable) -> None:
        self.tables[0] = t

    @property
    def num_experts(self) -> int:
        return self.tables[0].num_experts

    def reset(self) -> None:
        """Back to a fresh identity state (e.g. restoring a checkpoint
        written by a placement-free engine: weights are identity-ordered
        and there is no plan/predictor state to resume)."""
        self._setup(self.num_experts, self.pcfg, self.ep,
                    self.bytes_per_expert, self.cost_gate,
                    n_tables=self.n_tables)

    def device_tables(self):
        """(e2r, local_slot) for the MoE layer — ``[E]`` arrays for
        a shared table, stacked ``[L, E]`` for per-layer tables (threaded
        through the transformer's block loop)."""
        if not self.per_layer:
            return self.tables[0].as_tuple()
        return (np.stack([t.e2r for t in self.tables]),
                np.stack([t.local_slot for t in self.tables]))

    # -- engine feeds ------------------------------------------------------
    def observe(self, expert_stats: np.ndarray,
                decode: bool = False) -> None:
        """expert_stats [n_blocks, 2, E]: per-MoE-layer (load, vis) counts
        of one engine iteration (the transformer's ``aux["expert_stats"]``).
        ``decode`` routes the observation into the decode window when one
        is configured."""
        es = np.asarray(expert_stats, np.float64)
        self.predictor.observe(es[:, 0, :], es[:, 1, :], decode=decode)
        if decode:
            self._decode_since_replan += 1

    # -- replanning --------------------------------------------------------
    def _discipline_cfg(self) -> PlacementConfig:
        return self.pcfg

    def _replan_blocked(self) -> bool:
        return self.pcfg.planner == "identity"

    def layer_bytes(self, plan: Plan, layer: int) -> int:
        if isinstance(plan, migrate.LayerMigrationPlan):
            return int(plan.moved_per_layer[layer]) * self.bytes_per_expert
        return int(plan.moved_bytes)

    def _commit_one_layer(self, plan: Plan, layer: int) -> None:
        b = self.layer_bytes(plan, layer)
        if isinstance(plan, migrate.LayerMigrationPlan):
            self.tables[layer] = plan.new_tables[layer]
            self.migrated_experts += int(plan.moved_per_layer[layer])
        else:
            self.tables[0] = plan.new_table
            self.migrated_experts += plan.n_moved
        self.migrated_bytes += b
        self.migrated_bytes_per_layer[layer] += b

    def _replan_shared(self, it: int, regime: str) -> Optional[Plan]:
        """The shared-table planning attempt (cadence already hit —
        the discipline's ``maybe_replan`` dispatched here)."""
        load, vis = self.predictor.predict(regime)
        if load.sum() <= 0:
            return self._decide("zero-load")
        p = self.pcfg
        forced = self._event_now
        new = plan_placement(p.planner, load, self.ep, vis=vis, cfg=p)
        # skip churn: require a predicted max-rank-load improvement
        # (event-triggered replans bypass the guard and the cost gate)
        old_max = self.table.rank_loads(load).max()
        new_max = new.rank_loads(load).max()
        gain = (old_max - new_max) / old_max if old_max > 0 else 0.0
        if not forced and (old_max <= 0 or gain < p.min_gain):
            return self._decide("min-gain", pred_gain=float(gain))
        plan = migrate.diff(self.table, new, self.bytes_per_expert)
        if plan.is_noop:
            return self._decide("noop", pred_gain=float(gain),
                                changed_layers=0)
        price = dict(
            pred_gain=float(gain),
            migration_bytes=int(plan.moved_bytes),
            migration_s=float(self.migration_seconds(plan.moved_bytes)),
            n_moved=int(plan.n_moved))
        if not forced and not self._gate_accept(
                self.table.rank_loads(load), new.rank_loads(load),
                plan.n_moved):
            return self._decide("cost-gate", **price)
        self.last_replan_iter = it
        self._decide("staged", **price)
        return self._stage(plan)

    def rank_heatmap(self, expert_stats, slot_stats=None) -> np.ndarray:
        """Realized per-layer per-rank loads ``[n_blocks, ep]`` of one
        iteration's ``aux["expert_stats"]`` under the routable tables."""
        loads = np.asarray(expert_stats, np.float64)[:, 0, :]
        if self.per_layer and loads.shape[0] == self.n_tables:
            return np.stack([self.tables[l].rank_loads(loads[l])
                             for l in range(loads.shape[0])])
        return np.stack([self.table.rank_loads(loads[l])
                         for l in range(loads.shape[0])])

    # per-layer replan hooks (loop lives in ReplanDiscipline)
    def _layer_states(self) -> list:
        return self.tables

    def _plan_one_layer(self, load: np.ndarray,
                        vis: np.ndarray) -> PlacementTable:
        return plan_placement(self.pcfg.planner, load, self.ep, vis=vis,
                              cfg=self.pcfg)

    def _diff_layer_states(self, old_states: list, new_states: list
                           ) -> migrate.LayerMigrationPlan:
        return migrate.diff_layers(old_states, new_states,
                                   self.bytes_per_expert)

    def _accept_layer_plan(self, plan: migrate.LayerMigrationPlan,
                           new_states: list) -> migrate.LayerMigrationPlan:
        return self._stage(plan)

    def migration_seconds(self, moved_bytes: int) -> float:
        """Virtual-time cost of moving ``moved_bytes`` over the EP fabric
        — priced at the measured-bandwidth EWMA (the configured
        ``migration_bw`` until the first timed apply calibrates it)."""
        return self.bandwidth.seconds(moved_bytes)

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        out = {"e2r": np.stack([t.e2r for t in self.tables]),
               "local_slot": np.stack([t.local_slot for t in self.tables]),
               "n_ranks": np.int64(self.ep),
               "n_tables": np.int64(self.n_tables),
               "n_migrations": np.int64(self.n_migrations),
               "migrated_bytes": np.int64(self.migrated_bytes),
               "migrated_experts": np.int64(self.migrated_experts),
               "migrated_bytes_per_layer": self.migrated_bytes_per_layer}
        for k, v in self.predictor.state_dict().items():
            out[f"pred_{k}"] = v
        return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        assert int(state["n_ranks"]) == self.ep, \
            (int(state["n_ranks"]), self.ep)
        nt = int(state.get("n_tables", 1))
        if nt != self.n_tables:
            raise ValueError(
                f"checkpoint holds {nt} placement table(s) but this "
                f"manager plans {self.n_tables} — per-layer and "
                "shared-table checkpoints are not interchangeable (the "
                "saved weights are permuted per the writer's tables)")
        e2r = np.atleast_2d(np.asarray(state["e2r"], np.int32))
        ls = np.atleast_2d(np.asarray(state["local_slot"], np.int32))
        self.tables = [PlacementTable(e2r[l], ls[l], self.ep)
                       for l in range(self.n_tables)]
        self.n_migrations = int(state["n_migrations"])
        self.migrated_bytes = int(state["migrated_bytes"])
        self.migrated_experts = int(state["migrated_experts"])
        self.migrated_bytes_per_layer = np.asarray(
            state.get("migrated_bytes_per_layer",
                      np.zeros(self.n_tables)), np.int64).reshape(
            self.n_tables)
        self._decode_since_replan = 0
        self._pending = None
        self._pending_remaining = None
        self.predictor.load_state_dict(
            {k[len("pred_"):]: v for k, v in state.items()
             if k.startswith("pred_")})

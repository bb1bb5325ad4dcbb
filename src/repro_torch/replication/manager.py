"""ReplicaManager: the serving-side control loop of expert replication.

The replication twin of
:class:`~repro_torch.placement.manager.PlacementManager`
— same EWMA predictor, same cadence/churn discipline — but the planner
produces a :class:`ReplicaSet` and the migration path adds/retires
replica slabs instead of permuting a bijection.

Two-phase consistency (a replica is routable only after its slab lands):
``maybe_replan`` *stages* a plan and keeps serving the old set; the
engine gathers the weight slabs (``placement.migrate.apply_to_params``)
and only then calls ``commit(plan)``, which flips the routable table and
books the accounting.  Under async overlapped migration the commit is
per layer: ``commit_layers(plan, layers)`` flips exactly the layers
whose slab chunks have landed (``repro_torch.serving.async_migrate``), so the
consistency rule holds layer-wise while the rest of the plan drains.  A
crashed / abandoned apply (``abort``) leaves the old set fully
consistent with the untouched weights.  The staging/commit machinery is
shared with :class:`~repro_torch.placement.manager.PlacementManager` via
``ReplanDiscipline``.

Per-layer replica sets (``ReplicationConfig.per_layer``): one set per
scanned MoE block, each planned from its own predictor row; the staged
plan is a layer-diff (:class:`~repro_torch.replication.migrate.
LayerReplicaMigrationPlan`) whose slab traffic covers changed layers
only, and ``device_tables`` returns stacked ``[L, ...]`` arrays for the
transformer's block loop.  ``n_tables == 1`` degrades bitwise to the
shared-set behavior.

Decode-regime replanning mirrors placement: a separate decode EWMA
window (``decode_halflife``) plus a decode-iteration cadence
(``decode_replan_every``).

Optionally gated by a cost model (``cost_gate``): a replan fires only
when the predicted layer-time savings over the plan's amortization
horizon exceed the migration cost — see
:class:`benchmarks.costmodel.ReplanCostGate`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.configs.base import ModelConfig, ReplicationConfig
from repro_torch.placement import migrate as pmigrate
from repro_torch.placement.manager import ReplanDiscipline
from repro_torch.placement.predictor import EWMAPredictor
from repro_torch.replication import migrate
from repro_torch.replication.planner import plan_replication
from repro_torch.replication.replica_set import ReplicaSet

Plan = Union[migrate.ReplicaMigrationPlan, migrate.LayerReplicaMigrationPlan]


class ReplicaManager(ReplanDiscipline):
    ckpt_group = "replication"     # engine checkpoint group name
    _kind = "replication"          # audit / span label

    def __init__(self, cfg: ModelConfig, rpcfg: ReplicationConfig, ep: int,
                 cost_gate=None):
        assert cfg.moe is not None, "replication requires an MoE model"
        n_blocks, n_moe_per_block = cfg.moe_block_structure()
        n_moe = n_blocks * n_moe_per_block
        if rpcfg.per_layer:
            n_tables = n_blocks
            bpe = pmigrate.expert_bytes(cfg, max(n_moe_per_block, 1))
        else:
            n_tables = 1
            bpe = pmigrate.expert_bytes(cfg, max(n_moe, 1))
        self._setup(cfg.moe.num_experts, rpcfg, ep, bpe, cost_gate,
                    n_tables=n_tables)
        self.cfg = cfg

    @classmethod
    def from_geometry(cls, num_experts: int, rpcfg: ReplicationConfig,
                      ep: int, bytes_per_expert: int = 0,
                      cost_gate=None, n_layers: int = 1) -> "ReplicaManager":
        """Model-config-free construction (cost-model simulators).

        ``bytes_per_expert`` is per-table granularity: the whole stack for
        a shared manager, one scanned block for a per-layer one."""
        self = cls.__new__(cls)
        self._setup(num_experts, rpcfg, ep, bytes_per_expert, cost_gate,
                    n_tables=n_layers if rpcfg.per_layer else 1)
        self.cfg = None
        return self

    def _setup(self, num_experts: int, rpcfg: ReplicationConfig, ep: int,
               bytes_per_expert: int, cost_gate=None, n_tables: int = 1):
        assert num_experts % ep == 0, (num_experts, ep)
        assert n_tables >= 1, n_tables
        self.rpcfg, self.ep = rpcfg, ep
        self.n_tables = n_tables
        self.slots_per_rank = num_experts // ep + rpcfg.spare_per_rank
        self.rsets: List[ReplicaSet] = [
            ReplicaSet.identity(num_experts, ep,
                                slots_per_rank=self.slots_per_rank,
                                max_replicas=rpcfg.max_replicas)
            for _ in range(n_tables)]
        self.predictor = EWMAPredictor(num_experts, alpha=rpcfg.ewma_alpha,
                                       decode_halflife=rpcfg.decode_halflife)
        self.bytes_per_expert = bytes_per_expert
        self.cost_gate = cost_gate
        # measured-bandwidth EWMA pricing this manager's slab copies;
        # shared with the cost gate so both price the same bytes/s
        self.bandwidth = pmigrate.MigrationBandwidth(rpcfg.migration_bw)
        if cost_gate is not None \
                and getattr(cost_gate, "bandwidth", False) is None:
            cost_gate.bandwidth = self.bandwidth
        self._pending: Optional[Plan] = None
        self._pending_remaining = None
        # elastic serving: which EP ranks are live.  Dead ranks are masked
        # out of the capacity model, the planner and the split weights;
        # the ElasticCoordinator owns the transitions.
        self.rank_alive = np.ones(ep, bool)
        self.must_layers = set()
        self._event_replan = False
        # cumulative accounting
        self.n_migrations = 0
        self.migrated_bytes = 0
        self.migrated_slots = 0
        self.migrated_bytes_per_layer = np.zeros(n_tables, np.int64)
        self.last_replan_iter = -1
        self._decode_since_replan = 0
        self.cum_slot_load = np.zeros(self.n_slots, np.float64)

    # -- geometry ----------------------------------------------------------
    @property
    def per_layer(self) -> bool:
        return self.n_tables > 1

    @property
    def rset(self) -> ReplicaSet:
        """The shared set (first set of a per-layer manager)."""
        return self.rsets[0]

    @rset.setter
    def rset(self, rs: ReplicaSet) -> None:
        self.rsets[0] = rs

    @property
    def num_experts(self) -> int:
        return self.rsets[0].num_experts

    @property
    def n_slots(self) -> int:
        return self.ep * self.slots_per_rank

    def reset(self) -> None:
        """Back to a fresh identity state (e.g. restoring a checkpoint
        written by a replication-free engine: weights are logical-order
        and there is no replica state to resume)."""
        self._setup(self.num_experts, self.rpcfg, self.ep,
                    self.bytes_per_expert, self.cost_gate,
                    n_tables=self.n_tables)

    def device_tables(self):
        """(rep_pos, n_rep, slot_owner[, split_sched]) of the *routable*
        set(s) — staged plans are invisible here until committed.
        Stacked ``[L, ...]`` arrays for a per-layer manager (scanned
        alongside the block params), plain arrays for a shared one.
        Under ``weighted_split`` a 4th entry carries the per-expert
        replica schedule built from the predictor's residual-capacity
        weights (equal-share until the first observation)."""
        if not self.per_layer:
            base = self.rsets[0].as_arrays()
            if not self.rpcfg.weighted_split:
                return base
            return base + (self._split_schedules()[0],)
        base = (np.stack([rs.rep_pos for rs in self.rsets]),
                np.stack([rs.n_rep for rs in self.rsets]),
                np.stack([rs.slot_owner for rs in self.rsets]))
        if not self.rpcfg.weighted_split:
            return base
        return base + (np.stack(self._split_schedules()),)

    def _split_schedules(self) -> List[np.ndarray]:
        """Per-set ``[E, Q]`` weighted-split schedules from the predicted
        loads (residual host-rank capacity; dead ranks weight 0)."""
        pred = self.predictor.predict_layers("mixed")
        loads = None
        if pred is not None and pred[0].sum() > 0:
            loads = pred[0]
        out = []
        alive = self._rank_alive_arg()
        for l, rs in enumerate(self.rsets):
            if loads is None:
                out.append(rs.split_schedule())
                continue
            load_l = loads[l] if (self.per_layer
                                  and loads.shape[0] == self.n_tables) \
                else loads.sum(0)
            w = rs.residual_split_weights(load_l, rank_alive=alive)
            out.append(rs.split_schedule(w))
        return out

    def wants_table_refresh(self, it: int) -> bool:
        """Should the engine rebuild its cached device tables at ``it``
        even though no plan committed?  Weighted-split schedules track
        the predictor, so they are refreshed on the replan cadence."""
        return (self.rpcfg.weighted_split and self.rpcfg.replan_every > 0
                and it % self.rpcfg.replan_every == 0)

    # -- elastic serving ---------------------------------------------------
    def _rank_alive_arg(self) -> Optional[np.ndarray]:
        """``rank_alive`` for planner/capacity calls — None while every
        rank is live (the planners' zero-drift default path)."""
        return None if self.rank_alive.all() else self.rank_alive.copy()

    def mask_dead_ranks(self) -> Dict[int, np.ndarray]:
        """Re-pad every routable set onto the live ranks (an immediate
        table flip: surviving replicas' slabs are already resident).
        Returns ``{layer: lost_experts}`` for experts with no surviving
        replica — unroutable until re-materialized from checkpoint."""
        lost: Dict[int, np.ndarray] = {}
        for l, rs in enumerate(self.rsets):
            masked, lost_l = rs.masked(self.rank_alive)
            self.rsets[l] = masked
            if lost_l.size:
                lost[l] = lost_l
        return lost

    def hosts_rank(self, rank: int) -> bool:
        """Does any routable set keep a live replica on ``rank``?"""
        return any(rs.hosts_rank(rank) for rs in self.rsets)

    # -- engine feeds ------------------------------------------------------
    def observe(self, expert_stats: np.ndarray,
                decode: bool = False) -> None:
        """expert_stats [n_blocks, 2, E]: per-MoE-layer (load, vis) counts
        per *logical* expert of one engine iteration.  ``decode`` routes
        the observation into the decode window when one is configured."""
        es = np.asarray(expert_stats, np.float64)
        self.predictor.observe(es[:, 0, :], es[:, 1, :], decode=decode)
        if decode:
            self._decode_since_replan += 1

    def observe_slots(self, slot_stats: np.ndarray) -> None:
        """slot_stats [n_blocks, 2, S]: post-split physical-slot loads —
        cumulative replica-utilization accounting (diagnostics only)."""
        ss = np.asarray(slot_stats, np.float64)
        if ss.shape[-1] == self.n_slots:
            self.cum_slot_load += ss[:, 0, :].sum(0)

    # -- replica-aware dispatch capacity -----------------------------------
    def capacity_factor(self, margin: float = 1.25,
                        floor: float = 1.0) -> float:
        """Effective dispatch ``capacity_factor`` from the post-split
        predicted loads — the replica-aware shrink of the per-rank
        dispatch buffer.  Conservative on both axes: the worst layer
        (per-layer manager) and the worst prediction *window* price the
        buffer, so a decode-regime drift the main window cannot see
        still re-grows it.  Before any observation there is nothing to
        justify a shrink: returns +inf (the engine clamps to its static
        provision), never the floor."""
        out = 0.0
        seen = False
        for regime in ("mixed", "decode"):
            pred = self.predictor.predict_layers(regime)
            if pred is None:
                continue
            loads, _ = pred
            if loads.sum() <= 0:
                continue
            seen = True
            alive = self._rank_alive_arg()
            if self.per_layer and loads.shape[0] == self.n_tables:
                f = max(rs.capacity_factor(loads[l], margin, floor,
                                           rank_alive=alive)
                        for l, rs in enumerate(self.rsets))
            else:
                f = self.rset.capacity_factor(loads.sum(0), margin, floor,
                                              rank_alive=alive)
            out = max(out, f)
        return out if seen else float("inf")

    # -- replanning --------------------------------------------------------
    def _discipline_cfg(self) -> ReplicationConfig:
        return self.rpcfg

    def _replan_shared(self, it: int, regime: str) -> Optional[Plan]:
        """The shared-set planning attempt (cadence already hit — the
        discipline's ``maybe_replan`` dispatched here).  The staged plan
        is pending: the routable set(s) (and therefore
        ``device_tables``) are unchanged until :meth:`commit`."""
        p = self.rpcfg
        forced = self._event_now
        load, vis = self.predictor.predict(regime)
        if load.sum() <= 0:
            return self._decide("zero-load")
        new = plan_replication(load, self.ep, self.slots_per_rank,
                               max_replicas=p.max_replicas, vis=vis,
                               vis_weight=p.vis_weight,
                               rank_alive=self._rank_alive_arg())
        # churn guard: require a predicted post-split max-rank-load gain
        # (event-triggered replans — rank loss/rejoin — bypass the guard
        # and the cost gate: availability beats churn discipline)
        old_max = self.rset.rank_loads(load).max()
        new_max = new.rank_loads(load).max()
        gain = (old_max - new_max) / old_max if old_max > 0 else 0.0
        if not forced and (old_max <= 0 or gain < p.min_gain):
            return self._decide("min-gain", pred_gain=float(gain))
        plan = migrate.diff(self.rset, new, self.bytes_per_expert)
        if plan.is_noop:
            return self._decide("noop", pred_gain=float(gain),
                                changed_layers=0)
        price = dict(
            pred_gain=float(gain),
            migration_bytes=int(plan.moved_bytes),
            migration_s=float(self.migration_seconds(plan.moved_bytes)),
            n_moved=len(plan.crossrank_slots))
        if not forced and not self._gate_accept(
                self.rset.rank_loads(load), new.rank_loads(load),
                len(plan.crossrank_slots)):
            return self._decide("cost-gate", **price)
        self.last_replan_iter = it
        self._decide("staged", **price)
        return self._stage(plan)

    def rank_heatmap(self, expert_stats, slot_stats=None) -> np.ndarray:
        """Realized per-layer per-rank loads ``[n_blocks, ep]`` of one
        iteration.  Prefers the post-split physical ``slot_stats`` (the
        exact loads replica token-splitting produced); falls back to the
        logical expert stats under the routable sets' equal-split
        model."""
        if slot_stats is not None:
            ss = np.asarray(slot_stats, np.float64)
            if ss.shape[-1] == self.n_slots:
                return ss[:, 0, :].reshape(
                    ss.shape[0], self.ep, self.slots_per_rank).sum(-1)
        loads = np.asarray(expert_stats, np.float64)[:, 0, :]
        if self.per_layer and loads.shape[0] == self.n_tables:
            return np.stack([self.rsets[l].rank_loads(loads[l])
                             for l in range(loads.shape[0])])
        return np.stack([self.rset.rank_loads(loads[l])
                         for l in range(loads.shape[0])])

    # per-layer replan hooks (loop lives in ReplanDiscipline); the staged
    # layer-diff copies slabs for changed layers only, priced cross-rank
    def _layer_states(self) -> list:
        return self.rsets

    def _plan_one_layer(self, load: np.ndarray,
                        vis: np.ndarray) -> ReplicaSet:
        p = self.rpcfg
        return plan_replication(load, self.ep, self.slots_per_rank,
                                max_replicas=p.max_replicas, vis=vis,
                                vis_weight=p.vis_weight,
                                rank_alive=self._rank_alive_arg())

    def _diff_layer_states(self, old_states: list, new_states: list
                           ) -> migrate.LayerReplicaMigrationPlan:
        return migrate.diff_layers(old_states, new_states,
                                   self.bytes_per_expert)

    def _layer_gate_moved(self,
                          plan: migrate.LayerReplicaMigrationPlan) -> int:
        return plan.n_crossrank

    def _accept_layer_plan(self, plan: migrate.LayerReplicaMigrationPlan,
                           new_states: list
                           ) -> migrate.LayerReplicaMigrationPlan:
        return self._stage(plan)           # staged, routable only on commit

    def layer_bytes(self, plan: Plan, layer: int) -> int:
        if isinstance(plan, migrate.LayerReplicaMigrationPlan):
            return int(plan.crossrank_per_layer[layer]) \
                * self.bytes_per_expert
        return int(plan.moved_bytes)

    def _commit_one_layer(self, plan: Plan, layer: int) -> None:
        b = self.layer_bytes(plan, layer)
        if isinstance(plan, migrate.LayerReplicaMigrationPlan):
            self.rsets[layer] = plan.new_sets[layer]
            self.migrated_slots += int(plan.changed_per_layer[layer])
        else:
            self.rsets[0] = plan.new_set
            self.migrated_slots += plan.n_moved
        self.migrated_bytes += b
        self.migrated_bytes_per_layer[layer] += b

    def migration_seconds(self, moved_bytes: int) -> float:
        """Virtual-time cost of copying ``moved_bytes`` over the fabric
        — priced at the measured-bandwidth EWMA (the configured
        ``migration_bw`` until the first timed apply calibrates it)."""
        return self.bandwidth.seconds(moved_bytes)

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        out = {"rep_pos": np.stack([rs.rep_pos for rs in self.rsets]),
               "n_rep": np.stack([rs.n_rep for rs in self.rsets]),
               "n_ranks": np.int64(self.ep),
               "n_tables": np.int64(self.n_tables),
               "slots_per_rank": np.int64(self.slots_per_rank),
               "n_migrations": np.int64(self.n_migrations),
               "migrated_bytes": np.int64(self.migrated_bytes),
               "migrated_slots": np.int64(self.migrated_slots),
               "migrated_bytes_per_layer": self.migrated_bytes_per_layer,
               "cum_slot_load": self.cum_slot_load}
        for k, v in self.predictor.state_dict().items():
            out[f"pred_{k}"] = v
        return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        assert int(state["n_ranks"]) == self.ep, \
            (int(state["n_ranks"]), self.ep)
        assert int(state["slots_per_rank"]) == self.slots_per_rank, \
            (int(state["slots_per_rank"]), self.slots_per_rank)
        nt = int(state.get("n_tables", 1))
        if nt != self.n_tables:
            raise ValueError(
                f"checkpoint holds {nt} replica set(s) but this manager "
                f"plans {self.n_tables} — per-layer and shared "
                "checkpoints are not interchangeable (the saved weights "
                "are slot-ordered per the writer's sets)")
        rep_pos = np.asarray(state["rep_pos"], np.int32)
        n_rep = np.asarray(state["n_rep"], np.int32)
        if rep_pos.ndim == 2:          # legacy single-set layout
            rep_pos, n_rep = rep_pos[None], n_rep[None]
        assert rep_pos.shape[-1] == self.rsets[0].max_replicas, \
            (rep_pos.shape, self.rsets[0].max_replicas)
        self.rsets = [ReplicaSet(rep_pos[l], n_rep[l], self.ep,
                                 self.slots_per_rank)
                      for l in range(self.n_tables)]
        self.n_migrations = int(state["n_migrations"])
        self.migrated_bytes = int(state["migrated_bytes"])
        self.migrated_slots = int(state["migrated_slots"])
        self.migrated_bytes_per_layer = np.asarray(
            state.get("migrated_bytes_per_layer",
                      np.zeros(self.n_tables)), np.int64).reshape(
            self.n_tables)
        self.cum_slot_load = np.asarray(state["cum_slot_load"], np.float64)
        self._pending = None
        self._pending_remaining = None
        self._decode_since_replan = 0
        # elastic state is runtime-only (a restore implies a restart onto
        # a healthy mesh); checkpoints are refused mid-recovery anyway
        self.rank_alive = np.ones(self.ep, bool)
        self.must_layers = set()
        self._event_replan = False
        self.predictor.load_state_dict(
            {k[len("pred_"):]: v for k, v in state.items()
             if k.startswith("pred_")})

"""Redundant experts: replication with deterministic token splitting.

The third arm of the load-balancing comparison (vs. ReaLB's precision
switching and ``repro_torch.placement``'s bijective remapping): an EPLB-style
planner duplicates the predictor's hottest (vision-weighted) experts
into spare weight slots, the MoE layer splits each hot expert's routed
tokens round-robin across its replicas (see
``repro_torch.core.ep_moe.Replication``), and live replica add/drop rides the
placement weight-slab gather with a two-phase consistency rule — a
replica becomes routable only after its slab lands.
"""
from repro_torch.replication.manager import ReplicaManager
from repro_torch.replication.migrate import (LayerReplicaMigrationPlan,
                                             ReplicaMigrationPlan, diff,
                                             diff_layers, expand_moe_params)
from repro_torch.replication.planner import plan_from_config, plan_replication
from repro_torch.replication.replica_set import ReplicaSet

__all__ = [
    "ReplicaManager", "ReplicaMigrationPlan", "LayerReplicaMigrationPlan",
    "diff", "diff_layers", "expand_moe_params",
    "plan_from_config", "plan_replication", "ReplicaSet",
]

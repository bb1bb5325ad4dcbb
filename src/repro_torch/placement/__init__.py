"""Predictive expert→rank placement & live migration.

The slow-timescale complement to ReaLB's fast precision switching: an
EWMA predictor of per-expert routed load feeds capacity-constrained
planners (``identity`` / ``least_loaded`` / ``modality_aware``) whose
plans are applied as live weight-slab permutations on a configurable
cadence — so persistent routing skew is remapped away while FP4
compression absorbs the bursts no plan can anticipate.  See
``repro_torch.core.ep_moe`` for how the traced table enters the MoE layer and
``repro_torch.serving.engine`` for the serving-side loop.
"""
from repro_torch.placement.manager import PlacementManager
from repro_torch.placement.migrate import (
    LayerMigrationPlan, MigrationBandwidth, MigrationPlan,
    apply_layers_to_params, apply_to_params, diff, diff_layers, expert_bytes,
    moe_param_paths, subset_plan)
from repro_torch.placement.planner import (PLANNERS, plan_identity,
                                     plan_least_loaded, plan_modality_aware,
                                     plan_placement)
from repro_torch.placement.predictor import EWMAPredictor
from repro_torch.placement.table import PlacementTable

__all__ = [
    "PlacementManager", "MigrationPlan", "LayerMigrationPlan",
    "MigrationBandwidth", "apply_to_params", "apply_layers_to_params",
    "subset_plan", "diff", "diff_layers",
    "expert_bytes", "moe_param_paths", "PLANNERS", "plan_identity",
    "plan_least_loaded", "plan_modality_aware", "plan_placement",
    "EWMAPredictor", "PlacementTable",
]

"""Placement planners: predicted per-expert loads → an expert→rank table.

All planners are capacity-constrained (every rank ends with exactly
``E // n_ranks`` experts — slabs are statically shaped) and pure host
numpy, so they are unit-testable and reusable by the analytic cost-model
simulators in ``benchmarks/costmodel.py``.

* ``identity``        — the contiguous mapping; never migrates.
* ``least_loaded``    — greedy LPT bin packing of predicted loads: place
  experts heaviest-first, each onto the rank with the least accumulated
  predicted load that still has a free slot.  The classic
  HarMoEny/EPLB-style rebalancing objective (minimize the max rank load).
* ``modality_aware``  — co-locate vision-heavy experts so FP4 ranks are
  *concentrated* rather than spread: under ReaLB, a rank compresses when
  it is hot **and** vision-dominated, so packing the vision-heavy experts
  onto few ranks lets the hybrid compress a small slice of the model
  instead of quantizing everywhere.  Experts are packed onto ranks in
  descending vision-load order (rank 0 gets the most vision-heavy slab),
  then a bounded swap pass rebalances total load between ranks, swapping
  only expert pairs with similar vision ratio (``vis_tol``) so the
  concentration survives the rebalance.

Every bijective planner is bounded below by the hottest single expert —
a load no permutation can split.  When that bound binds, use the
redundant-expert planner (:mod:`repro_torch.replication.planner`) instead,
which divides hot experts across ranks.

All planners consume ONE ``[E]`` load row, so per-layer planning
(``PlacementConfig.per_layer``) is simply the manager mapping them over
the predictor's ``[L, E]`` rows — one independent plan per scanned MoE
block, diffed into a layer-diff migration.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.configs.base import PlacementConfig
from repro_torch.placement.table import PlacementTable

PLANNERS = ("identity", "least_loaded", "modality_aware")


def plan_identity(num_experts: int, n_ranks: int) -> PlacementTable:
    return PlacementTable.identity(num_experts, n_ranks)


def plan_least_loaded(load: np.ndarray, n_ranks: int) -> PlacementTable:
    """Greedy LPT with per-rank slot capacity."""
    load = np.asarray(load, np.float64)
    e = load.shape[0]
    e_loc = e // n_ranks
    rank_load = np.zeros(n_ranks)
    rank_free = np.full(n_ranks, e_loc)
    e2r = np.empty(e, np.int32)
    for ex in np.argsort(-load, kind="stable"):
        open_ranks = np.flatnonzero(rank_free > 0)
        r = open_ranks[np.argmin(rank_load[open_ranks])]
        e2r[ex] = r
        rank_load[r] += load[ex]
        rank_free[r] -= 1
    return PlacementTable.from_ranks(e2r, n_ranks)


def plan_modality_aware(load: np.ndarray, vis: np.ndarray, n_ranks: int,
                        vis_tol: float = 0.25,
                        max_swaps: int = 64) -> PlacementTable:
    load = np.asarray(load, np.float64)
    vis = np.asarray(vis, np.float64)
    e = load.shape[0]
    e_loc = e // n_ranks
    # phase 1: concentrate — fill ranks in descending vision-load order
    order = np.argsort(-vis, kind="stable")
    e2r = np.empty(e, np.int32)
    e2r[order] = np.arange(e) // e_loc
    # phase 2: bounded rebalance of total load via vis-similar swaps
    r_v = vis / np.maximum(load, 1e-12)
    for _ in range(max_swaps):
        rl = np.zeros(n_ranks)
        np.add.at(rl, e2r, load)
        hi, lo = int(np.argmax(rl)), int(np.argmin(rl))
        spread = rl[hi] - rl[lo]
        if hi == lo or spread <= 1e-12:
            break
        cand_hi = np.flatnonzero(e2r == hi)
        cand_lo = np.flatnonzero(e2r == lo)
        # best swap: move ~spread/2 of load from hi to lo, keeping the
        # swapped experts' vision ratios within vis_tol of each other
        best, best_err = None, spread / 2.0
        for a in cand_hi:
            for b in cand_lo:
                if abs(r_v[a] - r_v[b]) > vis_tol:
                    continue
                delta = load[a] - load[b]
                err = abs(delta - spread / 2.0)
                if 0.0 < delta < spread and err < best_err:
                    best, best_err = (a, b), err
        if best is None:
            break
        a, b = best
        e2r[a], e2r[b] = lo, hi
    return PlacementTable.from_ranks(e2r, n_ranks)


def plan_placement(name: str, load: np.ndarray, n_ranks: int,
                   vis: Optional[np.ndarray] = None,
                   cfg: Optional[PlacementConfig] = None) -> PlacementTable:
    """Dispatch by planner name (`PlacementConfig.planner`)."""
    cfg = cfg or PlacementConfig()
    e = np.asarray(load).shape[0]
    if name == "identity":
        return plan_identity(e, n_ranks)
    if name == "least_loaded":
        return plan_least_loaded(load, n_ranks)
    if name == "modality_aware":
        v = np.zeros(e) if vis is None else vis
        return plan_modality_aware(load, v, n_ranks,
                                   vis_tol=cfg.vis_tol,
                                   max_swaps=cfg.max_swaps)
    raise ValueError(f"unknown planner {name!r}; known: {PLANNERS}")

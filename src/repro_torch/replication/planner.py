"""EPLB-style replication planner: predicted expert loads → a ReplicaSet.

Two greedy phases, both deterministic (stable sorts, first-index
tie-breaks) so repeated planning from identical predictions yields
identical sets and the diff is a no-op:

1. *Replica counting* — spend the spare slots one at a time on the
   expert with the largest current per-replica hotness
   ``(load + vis_weight * vis) / count`` (the marginal-gain greedy of
   fractional EPLB), capped at ``max_replicas`` and at ``n_ranks``
   (replicas must live on distinct ranks).  Vision-heavy experts are
   preferentially replicated: under a multimodal burst they are both the
   hottest and the ones ReaLB would otherwise have to compress.

2. *Instance packing* — longest-processing-time bin packing of all
   replica instances (each carrying ``load / count``) onto ranks with
   ``slots_per_rank`` capacity, never putting two replicas of one expert
   on the same rank.  When every remaining feasible rank already hosts
   the expert, the instance is dropped (count reduced) rather than
   violating the distinct-rank invariant.

The planner consumes ONE ``[E]`` load row; per-layer replication
(``ReplicationConfig.per_layer``) maps it over the predictor's
``[L, E]`` rows — one independent replica set per scanned MoE block,
staged and committed as a layer-diff.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.configs.base import ReplicationConfig
from repro_torch.replication.replica_set import ReplicaSet


def plan_replication(load: np.ndarray, n_ranks: int, slots_per_rank: int,
                     max_replicas: int = 2,
                     vis: Optional[np.ndarray] = None,
                     vis_weight: float = 1.0,
                     rank_alive: Optional[np.ndarray] = None) -> ReplicaSet:
    load = np.asarray(load, np.float64)
    e = load.shape[0]
    vis = np.zeros(e) if vis is None else np.asarray(vis, np.float64)
    assert e % n_ranks == 0, (e, n_ranks)
    assert slots_per_rank >= e // n_ranks, (slots_per_rank, e, n_ranks)
    assert 1 <= max_replicas, max_replicas
    s = n_ranks * slots_per_rank
    # dead-rank-aware planning (elastic serving): dead ranks contribute no
    # slots, replica counts are capped at the live-rank count, and spare
    # spending is capped at the *live* slot surplus so every expert's
    # primary still fits (phase 2 would otherwise drop cold primaries)
    alive = (np.ones(n_ranks, bool) if rank_alive is None
             else np.asarray(rank_alive, bool))
    assert alive.shape == (n_ranks,), (alive.shape, n_ranks)
    n_live = int(alive.sum())
    assert n_live * slots_per_rank >= e, \
        f"{e} experts cannot fit on {n_live} live ranks x {slots_per_rank}"
    spare = n_live * slots_per_rank - e
    cap = min(max_replicas, n_live)
    score = load + vis_weight * vis

    # phase 1: replica counts by marginal per-replica hotness
    counts = np.ones(e, np.int64)
    for _ in range(spare):
        per = np.where(counts < cap, score / counts, -np.inf)
        best = int(np.argmax(per))
        if not np.isfinite(per[best]) or per[best] <= 0.0:
            break
        counts[best] += 1

    # phase 2: LPT packing of replica instances with distinct-rank rule
    share = load / counts
    inst_e = np.repeat(np.arange(e), counts)
    inst_share = np.repeat(share, counts)
    order = np.argsort(-inst_share, kind="stable")
    rank_load = np.zeros(n_ranks)
    rank_free = np.where(alive, slots_per_rank, 0).astype(np.int64)
    hosts = np.zeros((e, n_ranks), bool)
    placed_ranks = [[] for _ in range(e)]
    for i in order:
        ex = int(inst_e[i])
        ok = (rank_free > 0) & ~hosts[ex]
        if not ok.any():
            continue                    # drop instance: count shrinks
        cand = np.flatnonzero(ok)
        r = int(cand[np.argmin(rank_load[cand])])
        placed_ranks[ex].append(r)
        hosts[ex, r] = True
        rank_load[r] += inst_share[i]
        rank_free[r] -= 1
    # materialize slots: per rank, residents in ascending (expert, j) order
    rep_pos = np.zeros((e, max_replicas), np.int64)
    n_rep = np.zeros(e, np.int64)
    next_slot = np.arange(n_ranks) * slots_per_rank
    for ex in range(e):
        assert placed_ranks[ex], f"expert {ex} lost every replica slot"
        for r in sorted(placed_ranks[ex]):
            rep_pos[ex, n_rep[ex]] = next_slot[r]
            next_slot[r] += 1
            n_rep[ex] += 1
        rep_pos[ex, n_rep[ex]:] = rep_pos[ex, 0]
    return ReplicaSet(rep_pos.astype(np.int32), n_rep.astype(np.int32),
                      n_ranks, slots_per_rank)


def plan_from_config(load: np.ndarray, n_ranks: int,
                     rpcfg: ReplicationConfig,
                     vis: Optional[np.ndarray] = None,
                     slots_per_rank: int = 0) -> ReplicaSet:
    e = np.asarray(load).shape[0]
    s_loc = slots_per_rank or (e // n_ranks + rpcfg.spare_per_rank)
    return plan_replication(load, n_ranks, s_loc,
                            max_replicas=rpcfg.max_replicas, vis=vis,
                            vis_weight=rpcfg.vis_weight)

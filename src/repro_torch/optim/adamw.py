"""AdamW with a warmup-cosine schedule, on trees of tensors.

Counterpart of ``repro.optim.adamw``, with its semantics: f32 moments
whatever the parameter dtype, bias correction, decoupled weight decay on
tensors of rank 2 and up only, the warmup-cosine schedule with its 0.1
floor, and the global-norm clip cast back to each gradient's dtype.  Not
``torch.optim.AdamW``, whose schedule, decay and clipping differ.

Trees are nested dicts (in sorted key order, as ``jax.tree.leaves`` walks
them) whose leaves are tensors.  The reference's update is pure; here
:func:`adamw_update` writes the new parameters and moments into the
tensors it is given, one leaf at a time, so a step holds one leaf's
temporaries on top of the state and not a second copy of it (at full
width the f32 moments alone are 20 GB).  Its ``apply`` predicate stands in
for the reference's caller dropping a poisoned update: where it is false
on the device, nothing is written and the step does not advance.

The update runs over each leaf in chunks of at most ``CHUNK_ELEMS`` (an
elementwise pass: the same bits), so its f32 temporaries are a chunk's,
not the largest leaf's (the embedding's 1.3 GB at full width).

Under a mesh (``models.common.use_mesh``) each rank updates the leaves it
holds: the replicated ones whole and its shards of the expert stacks.
:func:`global_norm` counts every element of the global tree once (the
replicated leaves on each rank alone, the expert shards' squares summed
over every rank of the mesh), so the clip scale is the same on every rank,
and the ranks agree on ``apply`` (false on one rank: nothing written on
any).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.common import (DTYPES, current_mesh, is_expert_path,
                                       row_chunks, tree_items)
from repro_torch.models.common import tree_leaves as leaves
from repro_torch.models.common import tree_map

Tree = Any
F32 = torch.float32
CHUNK_ELEMS = 1 << 24        # elements an update pass holds at once


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Tree            # first moments (f32)
    nu: Tree            # second moments (f32)


def init_opt_state(params: Tree, cfg: TrainConfig) -> OptState:
    dt = DTYPES[cfg.opt_state_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    dev = next(leaves(params)).device
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(zeros, params), tree_map(zeros, params))


def abstract_opt_state(params: Tree, cfg: TrainConfig) -> OptState:
    """:func:`init_opt_state`'s state as ``meta`` tensors, for the shapes
    of ``params`` (the reference's ``abstract_opt_state``)."""
    return init_opt_state(tree_map(
        lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
        params), cfg)


def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """Linear warmup to ``cfg.lr``, then a cosine down to a tenth of it by
    ``total_steps`` (f32, on ``step``'s device)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    """The L2 norm of every leaf.  Under a mesh of more than one rank, of
    the global tree: the expert stacks' (each rank a shard) squares summed
    over the mesh, the replicated leaves' once."""
    mesh = current_mesh()
    if mesh is None or mesh.size("data") * mesh.size("model") == 1:
        total = 0
        for x in leaves(tree):
            total = total + torch.sum(torch.square(x.to(F32)))
        return torch.sqrt(total)
    from repro_torch.core.ep_moe import _dist_comm
    rep = part = None
    for path, x in tree_items(tree):
        sq = torch.sum(torch.square(x.to(F32)))
        if is_expert_path(path):
            part = sq if part is None else part + sq
        else:
            rep = sq if rep is None else rep + sq
    dev = next(leaves(tree)).device
    zero = torch.zeros((), dtype=F32, device=dev)
    part = _dist_comm(mesh).sum_over_mesh(zero if part is None else part)
    return torch.sqrt((zero if rep is None else rep) + part)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.to(F32) * scale).to(g.dtype)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    g = global_norm(grads)
    scale = _clip_scale(g, max_norm)
    return tree_map(lambda x: _clipped(x, scale), grads), g


def adamw_update(params: Tree, grads: Tree, state: OptState,
                 cfg: TrainConfig, apply: Optional[torch.Tensor] = None
                 ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, written into ``params`` and ``state``'s moments
    (returned, with the advanced step).  ``apply``: a 0-dim bool tensor;
    where it is false the parameters, moments and step stay as they were.
    Nothing is read on the host (a staged mesh's collectives copy through
    it).  Under a mesh the ranks' ``apply`` are and-ed."""
    mesh = current_mesh()
    if apply is not None and mesh is not None \
            and mesh.size("data") * mesh.size("model") > 1:
        from repro_torch.core.ep_moe import _dist_comm
        apply = _dist_comm(mesh).all_true(apply)
    step = state.step + 1
    lr = lr_schedule(step, cfg)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    b1, b2, eps = cfg.b1, cfg.b2, cfg.eps
    c1 = 1.0 - b1 ** step.to(F32)
    c2 = 1.0 - b2 ** step.to(F32)
    with torch.no_grad():
        for leaf in zip(leaves(params), leaves(grads), leaves(state.mu),
                        leaves(state.nu)):
            decay = leaf[0].dim() >= 2   # decoupled, on matrices only
            for p, g, m, v in zip(*(row_chunks(t, CHUNK_ELEMS)
                                    for t in leaf)):
                gf = _clipped(g, scale).to(F32)
                m2 = b1 * m + (1 - b1) * gf
                v2 = b2 * v + (1 - b2) * torch.square(gf)
                delta = (m2 / c1) / (torch.sqrt(v2 / c2) + eps)
                if decay:
                    delta = delta + cfg.weight_decay * p.to(F32)
                p2 = (p.to(F32) - lr * delta).to(p.dtype)
                if apply is not None:
                    p2 = torch.where(apply, p2, p)
                    m2 = torch.where(apply, m2, m)
                    v2 = torch.where(apply, v2, v)
                p.copy_(p2)
                m.copy_(m2.to(m.dtype))
                v.copy_(v2.to(v.dtype))
        if apply is not None:
            step = torch.where(apply, step, state.step)
    return params, OptState(step.to(torch.int32), state.mu, state.nu), \
        {"lr": lr, "grad_norm": gnorm}

"""numpy trees → the port's tensors, under the same key paths.

Feeds the port with the reference's parameters, caches and optimizer
state: pass it the JAX tree after ``jax.tree.map(np.asarray, tree)``; ``rank_shard`` cuts
the tree a rank of an EP mesh holds (its expert slots and, in the FSDP
layout training takes, their ``D/data`` slice), and so do
``params_from_numpy`` and ``opt_state_from_numpy`` given ``mesh=``.  A
JAX bf16 array becomes an ``ml_dtypes`` bfloat16 numpy array, which
``torch.from_numpy`` rejects, so bf16 goes through its 16-bit pattern.  Every leaf is copied:
JAX's buffers are read-only.  Like every entry point of the port, they
put the tensors on ``cuda`` unless the caller names a device.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import FSDP_DIM, resolve_device
from repro_torch.optim.adamw import OptState

Tree = Any


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    device = resolve_device(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def params_from_numpy(tree: Tree, device=None, mesh=None,
                      fsdp: bool = False) -> Tree:
    """Nested dicts (and tuples) of numpy arrays → the same of tensors.
    Under ``mesh``, the rank's shard (:func:`rank_shard`; with ``fsdp``,
    the FSDP layout's) on its device unless ``device`` names one."""
    if mesh is not None:
        return rank_shard(tree, mesh.size("model"), mesh.index("model"),
                          device=mesh.device if device is None else device,
                          fsdp=(mesh.size("data"), mesh.index("data"))
                          if fsdp else None)
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


cache_from_numpy = params_from_numpy


def opt_state_from_numpy(state, device=None, mesh=None, fsdp: bool = False):
    """A reference ``OptState`` (``step``, ``mu``, ``nu`` of numpy arrays,
    e.g. after ``jax.tree.map(np.asarray, opt)``) → the port's
    ``optim.adamw.OptState``; under ``mesh`` the rank's shard of the
    moments, as :func:`params_from_numpy` cuts the parameters."""
    step, mu, nu = state
    if mesh is not None and device is None:
        device = mesh.device
    return OptState(tensor_from_numpy(step, device),
                    params_from_numpy(mu, device, mesh, fsdp),
                    params_from_numpy(nu, device, mesh, fsdp))

MOE_KEYS = ("w_gate", "w_up", "w_down")


def slot_owner(placement, num_experts: int) -> np.ndarray:
    """The logical expert of each physical slot (``-1``: an empty spare),
    ``[S]`` or, for a per-layer table, ``[n_blocks, S]``.  ``placement``:
    None (identity), ``(e2r, local_slot)`` or a replication table whose
    third entry is ``slot_owner``."""
    if placement is None:
        return np.arange(num_experts)
    entries = [np.asarray(a) for a in placement]
    if len(entries) >= 3:
        return entries[2].astype(np.int64)
    e2r, local = entries[0].astype(np.int64), entries[1].astype(np.int64)
    pos = e2r * (num_experts // (int(e2r.max()) + 1)) + local
    owner = np.empty(pos.shape, np.int64)
    np.put_along_axis(owner, pos, np.broadcast_to(
        np.arange(num_experts), pos.shape), axis=-1)
    return owner


def _placed_slots(arr: np.ndarray, placement, num_experts: Optional[int],
                  part: Tuple[int, int]) -> np.ndarray:
    """Slots ``part = (i, n)`` -- the ``i``-th of ``n`` equal parts -- of
    an expert stack ``[.., E, a, b]`` in logical order, laid out in the
    table's physical slot order (empty spares zero; a per-layer table lays
    out block ``b`` by its row ``b``)."""
    e = num_experts or arr.shape[-3]
    owner = slot_owner(placement, e)
    n_slots = owner.shape[-1]
    i, n = part
    if n_slots % n:
        raise ValueError(f"{n_slots} slots over {n} ranks")
    mine = owner[..., i * n_slots // n:(i + 1) * n_slots // n]
    idx = np.maximum(mine, 0)
    if mine.ndim == 1:
        out = np.take(arr, idx, axis=-3)
    else:                           # per-layer rows over the blocks
        out = np.stack([arr[b][idx[b]] for b in range(arr.shape[0])])
    out[np.broadcast_to(mine < 0, out.shape[:-2])] = 0
    return out


def rank_shard(tree: Tree, ep: int, rank: int, placement=None,
               device=None, num_experts: Optional[int] = None,
               fsdp: Optional[Tuple[int, int]] = None) -> Tree:
    """One EP rank's parameters from the reference's numpy tree, whose
    expert stacks ``[.., E, a, b]`` are in logical order: each MoE stack
    laid out in the table's physical slot order (empty spares zero) and
    cut to the rank's ``S/ep`` slots; every other leaf whole.  A per-layer
    table lays out block ``b`` of the stacked blocks by its row ``b``.
    ``fsdp``: ``(rows, row)``, the FSDP layout's cut of each slot's D dim
    (``FSDP_DIM``) too, data row ``row``'s ``D/rows``.  Only the rank's
    part is copied to the device."""
    def walk(node, in_moe):
        if isinstance(node, dict):
            return {k: (cut(v, k) if in_moe and k in MOE_KEYS
                        else walk(v, k == "moe")) for k, v in node.items()}
        return tensor_from_numpy(node, device)

    def cut(arr, key):
        out = _placed_slots(np.asarray(arr), placement, num_experts,
                            (rank, ep))
        if fsdp is not None:
            rows, row = fsdp
            dim = out.ndim + FSDP_DIM[key]
            n_d = out.shape[dim]
            if n_d % rows:
                raise ValueError(f"{key}: D {n_d} over {rows} data rows")
            out = np.take(out, np.arange(row * n_d // rows,
                                         (row + 1) * n_d // rows), axis=dim)
        return tensor_from_numpy(out, device)

    device = resolve_device(device)
    return walk(tree, False)


def layout_shard(tree: Tree, spec: Tree, mesh, device=None, placement=None,
                 num_experts: Optional[int] = None) -> Tree:
    """This rank's parameters from the reference's numpy tree in the
    tensor-parallel layout (``models.layout``): every leaf cut by the
    rules in force as its declaration in ``spec`` gives its axes, at the
    leaf's own shape (a stacked leaf's leading dim whole; a replica
    engine's ``S`` expert slots, not the declared ``E``).  ``placement``
    (as :func:`rank_shard` takes it) lays each expert stack, given in
    logical order, out in the table's physical slot order on the host
    first; without it the stacks are taken as they are.  Only the rank's
    part is copied to the device."""
    from repro_torch.models.common import leaf_cuts
    device = resolve_device(mesh.device if device is None else device)

    def walk(node, decl, key):
        if isinstance(node, dict):
            return {k: walk(v, decl[k], k) for k, v in node.items()}
        arr = np.asarray(node)
        if placement is not None and key in MOE_KEYS \
                and len(decl.shape) == 3:
            arr = _placed_slots(arr, placement, num_experts, (0, 1))
        lead = arr.ndim - len(decl.shape)
        cut = leaf_cuts(arr.shape[lead:], decl.axes, mesh)
        return tensor_from_numpy(arr[(slice(None),) * lead + cut], device)
    return walk(tree, spec, None)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 widens to f32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()

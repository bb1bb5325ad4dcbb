"""Gradient accumulation, the data-parallel reduction of a mesh's
gradient, and the int8 error-feedback compressed reduction.

Counterpart of ``repro.optim.grad_utils``: :func:`accumulate_grads`
(microbatches, unrolled), :func:`init_error_feedback`,
:func:`_quantize_int8`, :func:`compress_leaf` (whose ``psum`` the caller
gives; the identity on one device), and the collective forms over the
port's ``Comm``: :func:`compressed_grad_psum` (int8 payload, error
feedback, reduced over a mesh axis) and :func:`compressed_all_reduce`
(its host-level entry on leaves stacked over the axis).  As in the
reference, the training loop does not use the compressed forms.

:func:`data_parallel_grads` is the exact reduction training under a mesh
takes: after the backward each data row holds its rows' part of the
gradient of every leaf it holds replicated (all but the expert shards of
the FSDP layout, whose gradient the FSDP gather's transpose already
summed over ``data``); it sums them over ``data``, so every rank holds the
global gradient (what the reference's ``jit(value_and_grad)`` gives).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models.common import (ROWS, current_mesh, cut_of,
                                       decl_at, is_expert_path,
                                       layout_spec, row_chunks, tree_items)
from repro_torch.models.common import tree_leaves as leaves
from repro_torch.models.common import tree_map

Tree = Any
F32 = torch.float32
# f32 elements reduced in one all-reduce (256 MB)
BUCKET_ELEMS = 1 << 26


def init_error_feedback(grads_like: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                          device=g.device), grads_like)


def _quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax / 127.0, min=1e-20)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_leaf(g: torch.Tensor, err: torch.Tensor,
                  psum: Callable[[torch.Tensor], torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: error feedback, int8 quantization, the reduction of the
    dequantized payload by ``psum``, and the new residual."""
    gf = g.to(F32) + err
    q, scale = _quantize_int8(gf)
    g_hat = q.to(F32) * scale
    new_err = gf - g_hat
    reduced = psum(q.to(torch.int32).to(F32) * scale)
    return reduced.to(g.dtype), new_err


def _comm(mesh):
    from repro_torch.core.ep_moe import _dist_comm
    return _dist_comm(mesh)


def compressed_grad_psum(grads: Tree, err: Tree, axis_name: str = "data",
                         mesh=None) -> Tuple[Tree, Tree]:
    """int8-compressed gradient all-reduce over the mesh axis ``axis_name``
    (``mesh``: default the current one) with error feedback: every leaf
    through :func:`compress_leaf` with one all-reduce of its dequantized
    payload.  Returns (reduced grads, new err); without a mesh the
    reduction is over one rank."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        psum = lambda x: x  # noqa: E731
    else:
        comm = _comm(mesh)
        psum = lambda x: comm.psum([x], axis=axis_name)[0]  # noqa: E731
    pairs = tree_map(lambda g, e: compress_leaf(g, e, psum), grads, err)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


def compressed_all_reduce(stacked_grads: Tree, stacked_err: Tree, mesh,
                          axis_name: str = "data") -> Tuple[Tree, Tree]:
    """Host-level entry (the reference's): every leaf is ``[R, ...]`` with
    ``R`` the mesh's size along ``axis_name``, the same on every rank;
    rank ``r`` of the axis reduces row ``r`` by :func:`compressed_grad_psum`.
    Returns the reduced tree with the (identical) reduction in every row
    and the error-feedback tree with each rank's residual in its row (the
    residuals all-gathered over the axis), the same on every rank."""
    n, i = mesh.size(axis_name), mesh.index(axis_name)
    for t in leaves(stacked_grads):
        if t.shape[0] != n:
            raise ValueError(f"a leaf of {tuple(t.shape)} stacked over the "
                             f"{n} ranks of {axis_name!r}")
    red, err = compressed_grad_psum(tree_map(lambda t: t[i], stacked_grads),
                                    tree_map(lambda t: t[i], stacked_err),
                                    axis_name, mesh)
    comm = _comm(mesh)
    return (tree_map(lambda t: t[None].expand(n, *t.shape).clone(), red),
            tree_map(lambda t: comm._gather(t, axis_name), err))


def data_parallel_grads(grads: Tree, spec: Optional[Tree] = None) -> Tree:
    """Sum over the current mesh's ``data`` axis of every leaf the data
    rows hold replicated, written into ``grads`` in place and returned:
    exact, in f32 all-reduces of up to ``BUCKET_ELEMS`` packed elements (a
    larger leaf in row chunks), each element rounded once to its leaf's
    dtype.  Every rank ends with the same bits.  The expert stacks (FSDP
    shards, already reduced) are left as they are; nothing happens on one
    data row.

    In the tensor-parallel layout (``spec``: the model's declarations,
    ``transformer.model_spec``, required there: see
    ``models.common.layout_spec``) a leaf is summed over the batch axes its
    cut does not use: every leaf whose ``embed`` dim is not cut over
    ``data`` (the FSDP gather's transpose reduced the others).  The sums
    over ``model`` of the leaves replicated there and applied to the
    sequence-parallel residual ran in the backward already, at their use
    (``models.layout.prepare``)."""
    mesh = current_mesh()
    if mesh is None:
        return grads
    comm = _comm(mesh)
    spec = layout_spec(spec, mesh)
    if spec is not None:
        groups: dict = {}
        for path, g in tree_items(grads):
            used = {a for c in cut_of(decl_at(spec, path), mesh) for a in c}
            axes = tuple(a for a in ROWS if mesh.size(a) > 1
                         and a not in used)
            if axes:
                groups.setdefault(axes, []).extend(
                    row_chunks(g, BUCKET_ELEMS))
        for axes, rep in groups.items():
            for lo, hi in buckets([g.numel() for g in rep]):
                _reduce_bucket(comm, rep[lo:hi], axes)
        return grads
    if mesh.size("data") == 1:
        return grads
    rep = [c for path, g in tree_items(grads) if not is_expert_path(path)
           for c in row_chunks(g, BUCKET_ELEMS)]
    for lo, hi in buckets([g.numel() for g in rep]):
        _reduce_bucket(comm, rep[lo:hi])
    return grads


def buckets(sizes, cap: int = BUCKET_ELEMS):
    """``[lo, hi)`` index ranges packing leaves of element counts
    ``sizes``, in order, into all-reduces of at most ``cap`` elements (a
    larger leaf alone)."""
    out, lo, size = [], 0, 0
    for i, n in enumerate(sizes):
        if i > lo and size + n > cap:
            out.append((lo, i))
            lo, size = i, 0
        size += n
    if lo < len(sizes):
        out.append((lo, len(sizes)))
    return out


def _reduce_bucket(comm, bucket, axes="data") -> None:
    flat = torch.cat([g.reshape(-1).to(F32) for g in bucket])
    comm._all_reduce(flat, axes, "grad_all_reduce")
    i = 0
    with torch.no_grad():
        for g in bucket:
            g.copy_(flat[i:i + g.numel()].reshape(g.shape).to(g.dtype))
            i += g.numel()


def _grads_of(loss: torch.Tensor, params: Tree) -> Tree:
    """d loss / d params, as a tree like ``params`` (zeros where the loss
    does not depend on a leaf)."""
    flat = list(leaves(params))
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, got)}
    return tree_map(lambda p: by_id[id(p)], params)


def value_and_grad(loss_fn: Callable, params: Tree, *args, **kw):
    """``((loss, aux), grads)`` of ``loss_fn(params, *args, **kw) -> (loss,
    aux)`` with respect to the tensors of ``params`` (which need not
    require gradients: they are taken as leaves of a fresh graph).  Under
    a mesh each rank's gradient is its own part (see
    :func:`data_parallel_grads`)."""
    with torch.enable_grad():
        ps = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, aux = loss_fn(ps, *args, **kw)
        grads = _grads_of(loss, ps)
    return (loss.detach(), aux), grads


def accumulate_grads(loss_fn: Callable, params: Tree, batches,
                     n_accum: int, **kw) -> Tuple[torch.Tensor, Tree, Any]:
    """Microbatched gradient accumulation (unrolled; n_accum is small).

    ``batches``: a dict of tensors with leading dim ``n_accum`` (the
    microbatch stack).  Returns (mean loss, mean grads, last aux)."""
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                         device=p.device), params)
    losses = []
    aux = None
    for i in range(n_accum):
        micro = tree_map(lambda x: x[i], batches)
        (loss, aux), g = value_and_grad(loss_fn, params, micro, **kw)
        acc = tree_map(lambda a, b: a + b.to(F32), acc, g)
        losses.append(loss)
    return (torch.stack(losses).mean(),
            tree_map(lambda g: g / n_accum, acc), aux)

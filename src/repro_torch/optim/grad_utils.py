"""Gradient accumulation and the int8 error-feedback leaf compression.

Counterpart of the one-device part of ``repro.optim.grad_utils``:
:func:`accumulate_grads` (microbatches, unrolled), :func:`init_error_feedback`,
:func:`_quantize_int8` and :func:`compress_leaf`, whose ``psum`` the caller
gives (the identity on one device).  The collective forms
(``compressed_grad_psum``, ``compressed_all_reduce``) belong to training
under a mesh, which is not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.models.common import tree_leaves as leaves
from repro_torch.models.common import tree_map

Tree = Any
F32 = torch.float32


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
    require gradients: they are taken as leaves of a fresh graph)."""
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

"""The tensor-parallel layout of the dense part under a mesh.

Counterpart of what the reference leaves to GSPMD: its parameters and
caches declare logical axes (``models.common.DEFAULT_RULES``) and
``logical_constraint`` pins the residual to ``("batch", "seq", None)``
between layers; GSPMD then places the collectives.  The port fixes them,
each an explicit, counted collective of ``core.ep_moe.Comm`` with its
transpose, and the function stays the reference's:

* a rank holds the ``B/rows`` rows of the batch (``batch`` over ``pod`` ×
  ``data``) and, where the sequence divides, its ``S/model`` slice of
  the residual (``seq`` over ``model``): the residual is
  sequence-parallel between layers (:attr:`TP.sp`).  A decode step's
  sequence of one stays whole on every rank of ``model``;
* every weight's ``embed`` dim is cut over ``data`` and gathered on use
  (:func:`prepare`), its gradient reduce-scattered back;
* a column-parallel layer (Q/K/V over ``heads``/``kv_heads``,
  ``w_gate``/``w_up`` over ``ffn``, the Mamba layer's ``d_inner``) takes
  the whole sequence (:meth:`TP.gather_seq`), a row-parallel one (``wo``,
  ``w_down``, ``w_out``) gives partial sums that go back to the residual's
  layout (:meth:`TP.reduce_out`: a reduce-scatter over the sequence, or
  in decode an ordered all-reduce);
* a weight whose dim does not divide over ``model`` is replicated there,
  as ``resolve_spec`` leaves it: its layer computes the rank's own rows
  of the residual (:meth:`TP.own_rows`), and nothing is summed over
  ``model``.  In training its gradient is the rank's rows' part, summed
  over ``model`` at its use (:func:`prepare` marks it,
  ``Comm.enter``).

A rank's gradient of what it holds is then the global loss's, as the
port's mesh convention has it (``core.ep_moe.Comm``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.ep_moe import _dist_comm
from repro_torch.models.common import P, cut_of

Tree = Any


class TP:
    """How the activations of one forward lie on the mesh: ``sp`` (the
    residual is this rank's ``S/model`` slice of the sequence), ``train``
    (autograd records: replicated weights are marked), ``s_full`` (the
    whole sequence's length)."""

    def __init__(self, mesh, sp: bool, train: bool = False,
                 s_full: int = 1):
        self.mesh = mesh
        self.comm = _dist_comm(mesh)
        self.m = mesh.size("model")
        self.r = mesh.index("model")
        self.sp = bool(sp)
        self.train = bool(train)
        self.s_full = int(s_full)
        self.s_local = self.s_full // self.m if self.sp else self.s_full

    # -- what a dim of n gives this rank ----------------------------------
    def cut(self, n: int) -> Tuple[int, int]:
        """``[lo, hi)`` of this rank's share of a dim of ``n`` cut over
        ``model`` (the whole dim where it does not divide)."""
        if n % self.m:
            return 0, n
        k = n // self.m
        return self.r * k, (self.r + 1) * k

    def divides(self, n: int) -> bool:
        return n % self.m == 0

    @property
    def seq_offset(self) -> int:
        """The position of this rank's first residual row in the
        sequence."""
        return self.r * self.s_local if self.sp else 0

    # -- activations -------------------------------------------------------
    def gather_seq(self, h: torch.Tensor) -> torch.Tensor:
        """The whole sequence of ``h`` (a column-parallel layer's input):
        sequence-parallel ``h`` all-gathered over ``model``; a replicated
        ``h`` entered as it is."""
        if self.sp:
            return self.comm.gather_cat(h, 1)
        return self.comm.enter(h)

    def reduce_out(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel layer's partial sums ``y`` (whole sequence) back
        to the residual's layout."""
        if self.sp:
            return self.comm.reduce_scatter_cat(y, 1)
        return self.comm.ordered_sum(y)

    def own_rows(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-sequence result every rank computed
        alike."""
        if self.sp:
            return y.narrow(1, self.seq_offset, self.s_local)
        return y

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        return self.comm.enter(t)

    def psum(self, t: torch.Tensor, kind: str = "tp_all_reduce"
             ) -> torch.Tensor:
        """``t`` summed over ``model`` in rank order (replicated after)."""
        return self.comm.ordered_sum(t, "model", kind)

    def gather_heads(self, t: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """Every rank's heads of ``t`` along ``dim`` (serving only)."""
        return self.comm._whole(t.contiguous(), dim, "model",
                                "head_all_gather")


def prepare(tree: Tree, spec: Tree, tp: TP) -> Tree:
    """One layer's weights (or the model's top-level leaves) ready to use
    in the tensor-parallel layout: each leaf's ``embed`` dim, where the
    rules cut it over ``data``, all-gathered (its transpose
    reduce-scatters the gradient); in sequence-parallel training a leaf
    not cut over ``model`` marked (``Comm.enter``: its gradient, each
    rank's rows' part, is summed over ``model`` at its use).  ``tree``
    holds the leaves as the layer uses them (a block's views: no stacked
    dim); the expert stacks pass unchanged (``core.ep_moe`` gathers
    them), the router is prepared."""
    if not isinstance(tree, dict):
        return _prepare_leaf(tree, spec, tp)
    out = {}
    for k, v in tree.items():
        if k == "moe":
            out[k] = {n: _prepare_leaf(t, spec[k][n], tp) if n == "router"
                      else t for n, t in v.items()}
        else:
            out[k] = prepare(v, spec[k], tp)
    return out


def _prepare_leaf(w: torch.Tensor, p: P, tp: TP) -> torch.Tensor:
    cuts = cut_of(p, tp.mesh)
    for dim, (axes, name) in enumerate(zip(cuts, p.axes or ())):
        if name == "embed" and axes and w.shape[dim] < p.shape[dim]:
            w = tp.comm.fsdp_gather(w, dim, axes)
    if tp.train and tp.sp and not any("model" in c for c in cuts):
        w = tp.comm.enter(w)
    return w


def kv_rows(cut: Tuple[str, ...], mesh, n_local: int) -> int:
    """The first row of the cache this rank holds along a ``kv_seq`` dim
    cut over the axes ``cut`` into slices of ``n_local`` rows."""
    return (mesh.index(cut) if cut else 0) * n_local


def whole_leaf(t: torch.Tensor, cut: Tuple[Tuple[str, ...], ...], mesh,
               kind: str = "checkpoint_gather") -> torch.Tensor:
    """The whole array of a leaf this rank holds the slice ``t`` of, cut
    over the axes ``cut`` of its trailing dims (a stacked leaf's leading
    dim is never cut): every rank's slice all-gathered over each dim's
    axes in turn (a collective over those axes: every rank calls it)."""
    comm = _dist_comm(mesh)
    off = t.dim() - len(cut)
    for i, axes in enumerate(cut):
        if axes and mesh.size(axes) > 1:
            t = comm._whole(t.detach().contiguous(), off + i, axes, kind)
    return t


def cut_leaf(t: torch.Tensor, cut: Tuple[Tuple[str, ...], ...],
             mesh) -> torch.Tensor:
    """This rank's slice of a whole leaf ``t`` cut over the axes ``cut`` of
    its trailing dims (:func:`whole_leaf`'s inverse)."""
    off = t.dim() - len(cut)
    for i, axes in enumerate(cut):
        if axes:
            n = t.shape[off + i] // mesh.size(axes)
            t = t.narrow(off + i, mesh.index(axes) * n, n)
    return t


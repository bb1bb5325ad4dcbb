"""Expert-parallel MoE layer with ReaLB load balancing.

Counterpart of ``repro.core.ep_moe``.  On one physical rank (no mesh) the
ReaLB policy statistics run over a *virtual* EP topology (``m_state [1,
vep]``): per-virtual-rank placed loads drive the policy and its AIMD
state, and one hot virtual rank quantizes every local expert (``use_fp4 =
any(dec.use_fp4)``).  Under a :class:`~repro_torch.models.common.Mesh` the
EP group is the ``model`` axis of real ``torch.distributed`` ranks, each
holding ``S/ep`` expert slots, and a rank quantizes its experts only when
its own entry of the decision is set (``dec.use_fp4[my_rank]``); the
collectives go through :class:`Comm`, which counts them.

Two paths, as in the reference:

* ``dispatch`` (prefill): route, policy, capacity-packed dispatch (an
  all-to-all over the group), conditional BF16→NVFP4 weight quantization
  (``kernels.ops.quantize_experts_fp4``) while the dispatch is in flight
  (under ReaLB-seq, ``overlap=False``, after it, with the reference's data
  dependency on it), grouped expert FFN (``kernels.ops.grouped_ffn`` with
  the BF16 weights, or the fused W4A4 ``kernels.ops.grouped_fp4_ffn``),
  the combine all-to-all back, gate-weighted combine.  In training
  (``train=True``) FP4 is off and only the BF16 grouped FFN runs, with
  its gradient kernel; under a mesh the expert slabs are FSDP-sharded
  over ``data`` and gathered before use, and every collective the layer
  crosses has its transpose (:class:`Comm`).
* ``broadcast`` (decode): every local expert on every token (dense
  per-expert products in BF16, the grouped W4A4 kernel in FP4), combine
  by one-hot gates, the partial sums added over the group in rank order.

In the tensor-parallel layout of the default rules (``models.layout``)
the layer receives the rank's rows and, in dispatch, its ``S/ep`` slice
of the sequence as they are (the residual is sequence-parallel), returns
its output for them, and gathers its expert stacks' D dim over ``data``
on use (serving too, as the reference's GSPMD gathers them into its
``shard_map``).

The BF16-or-FP4 decision stays on the device, as the reference's in-graph
``lax.cond`` keeps it: ``_use_fp4`` gives a 0-dim tensor ``f``, the
quantizer runs under ``f`` as a device predicate, the FP4 expert FFN runs
with slot counts ``gs·f`` and the BF16 one with ``gs·(1-f)`` (a kernel with
all-zero counts exits at once), and ``torch.where(f, ·, ·)`` returns the
chosen branch bit for bit.  Neither path reads a tensor on the host.  On
the CPU the same code runs the plain versions: the quantizer branches on
``f`` (a CPU tensor, free to read there) and the FFN with zero counts
computes nothing.

Differences forced by eager PyTorch:

* JAX drops out-of-bounds scatter writes and fills out-of-bounds gathers;
  torch raises.  Every such index (the ``big`` capacity-dropped slot) is
  written into a few spare rows past the buffer instead.
* ``jax.lax.top_k`` breaks ties toward the lower index; so does a stable
  descending sort, which replaces it.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig, ReaLBConfig
from repro_torch.core import quant
from repro_torch.core.policy import realb_policy
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (FSDP_DIM, ROWS, current_mesh,
                                       local_slice, tensor_parallel)

F32 = torch.float32
AUX_SCALARS = ("lb_loss", "z_loss", "drop_frac", "ib_global", "fp4_ranks",
               "gate_open", "split_frac")


# --------------------------------------------------------------------------
# expert placement / replication tables
# --------------------------------------------------------------------------
class Placement(NamedTuple):
    """Logical-expert → (rank, slot) bijection: ``e2r [E]``, ``local_slot [E]``."""
    e2r: torch.Tensor
    local_slot: torch.Tensor


class Replication(NamedTuple):
    """Logical-expert → replica slots: ``rep_pos [E, R]`` (entries past
    ``n_rep[e]`` repeat the primary), ``n_rep [E]``, ``slot_owner [S]``
    (``-1`` = empty spare slot)."""
    rep_pos: torch.Tensor
    n_rep: torch.Tensor
    slot_owner: torch.Tensor


class WeightedReplication(NamedTuple):
    """:class:`Replication` plus a weighted-split schedule:
    ``split_sched [E, Q]`` sends the ``occ``-th routed token of expert
    ``e`` to replica ``split_sched[e, occ % Q]`` (host-built deficit
    round-robin over residual-capacity weights; the plain 3-field
    ``Replication`` keeps the equal-share ``occ % n_rep`` split)."""
    rep_pos: torch.Tensor
    n_rep: torch.Tensor
    slot_owner: torch.Tensor
    split_sched: torch.Tensor


def identity_placement(num_experts: int, n_ranks: int,
                       device=None) -> Placement:
    """The contiguous mapping (expert ``e`` on rank ``e // e_loc``)."""
    ar = torch.arange(num_experts, dtype=torch.int32, device=device)
    e_loc = num_experts // n_ranks
    return Placement(ar // e_loc, ar % e_loc)


def identity_replication(num_experts: int, n_ranks: int,
                         device=None) -> Replication:
    """One replica per expert, no spare slots ≡ the identity placement."""
    ar = torch.arange(num_experts, dtype=torch.int32, device=device)
    return Replication(ar[:, None], torch.ones_like(ar), ar)


def _as_replication(placement, num_experts: int, pol_ep: int,
                    device) -> Replication:
    """None (identity), a ``Placement``/2-tuple, or a ``Replication``/3- or
    4-tuple (the 4th entry is the weighted-split schedule)."""
    if placement is None:
        return identity_replication(num_experts, pol_ep, device)
    if isinstance(placement, (Replication, WeightedReplication)):
        return placement
    entries = tuple(placement)
    if len(entries) == 4:
        return WeightedReplication(*entries)
    if len(entries) == 3:
        return Replication(*entries)
    if len(entries) != 2:
        raise ValueError(f"placement with {len(entries)} entries")
    place = Placement(*entries)
    e_loc = num_experts // pol_ep
    pos_e = place.e2r.to(torch.int32) * e_loc + place.local_slot.to(torch.int32)
    inv = torch.zeros((num_experts,), dtype=torch.int32, device=pos_e.device)
    inv[pos_e.long()] = torch.arange(num_experts, dtype=torch.int32,
                                     device=pos_e.device)
    return Replication(pos_e[:, None],
                       torch.ones((num_experts,), dtype=torch.int32,
                                  device=pos_e.device), inv)


def _bincount(idx: torch.Tensor, weights: Optional[torch.Tensor],
              length: int) -> torch.Tensor:
    """``jnp.bincount(idx, weights, length)`` for indices in [0, length);
    weights are 0/1 counts, so the f32 sums are exact in any order."""
    w = torch.ones(idx.shape, dtype=F32, device=idx.device) \
        if weights is None else weights.to(F32)
    return torch.zeros((length,), dtype=F32, device=idx.device) \
        .index_add_(0, idx.long(), w)


def _occurrence_index(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """[n] per-assignment rank among same-expert assignments (original
    order).  Entries equal to ``num_experts`` count only among themselves."""
    n = flat_e.shape[0]
    ord_e = torch.sort(flat_e, stable=True).indices
    counts = _bincount(flat_e, None, num_experts + 1).to(torch.int32)
    offs = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    occ_sorted = torch.arange(n, dtype=torch.int32, device=flat_e.device) \
        - offs[flat_e[ord_e].long()]
    occ = torch.zeros((n,), dtype=torch.int32, device=flat_e.device)
    occ[ord_e] = occ_sorted
    return occ


def _split_assignments(rep: Replication, flat_e: torch.Tensor,
                       valid_flat: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat_pos [n], is_secondary [n]): the physical slot of each routed
    assignment, round-robin over the expert's replicas, or by the
    weighted-split schedule when there is one (valid assignments only;
    padding pins to the primary)."""
    fe = flat_e.long()
    if rep.rep_pos.shape[1] == 1:      # bijective: skip the counter
        return rep.rep_pos[:, 0][fe], torch.zeros(flat_e.shape,
                                                  dtype=torch.bool,
                                                  device=flat_e.device)
    e = rep.rep_pos.shape[0]
    occ = _occurrence_index(torch.where(valid_flat, flat_e,
                                        torch.full_like(flat_e, e)), e)
    sched = getattr(rep, "split_sched", None)
    if sched is not None:
        q = sched.shape[1]
        ridx = torch.where(valid_flat, sched[fe, (occ % q).long()], 0)
    else:
        ridx = torch.where(valid_flat, occ % rep.n_rep[fe], 0)
    return rep.rep_pos[fe, ridx.long()], ridx > 0


# --------------------------------------------------------------------------
# communication (lets the same math run without a mesh)
# --------------------------------------------------------------------------
class CollectiveCensus:
    """Collectives issued, by kind: ``{"count", "bytes"}`` with the bytes of
    this rank's input (the payload it contributes).  ``psum`` counts the
    reference's psums, ``all_reduce`` the packed collectives that carry
    them and ``all_gather`` the one that carries the decode combine's
    ordered sum; ``layout_all_gather`` is the port's layout (the MoE
    output gathered over ``model``, and rows over ``data``), classed
    apart.  Between forwards: ``migrate_all_to_all`` (a migration's rows,
    the bytes sent to other ranks), ``agree_all_reduce`` (the ranks'
    agreements) and ``checkpoint_gather``.  In training: the transposes
    ``all_to_all_grad`` and ``layout_all_gather_grad``, the FSDP slabs'
    ``fsdp_all_gather`` and ``fsdp_reduce_scatter``, the loss's
    ``psum_data``/``all_reduce_data``, the replicated leaves'
    ``grad_all_reduce`` and the global norm's ``norm_all_gather``.  The
    tensor-parallel layout (``models.layout``): the residual's sequence
    gathered into column-parallel layers (``tp_all_gather``) and the
    row-parallel partials reduced back (``tp_reduce_scatter``, in decode
    ``tp_all_reduce``), the weights' D dims gathered over ``data``
    (``fsdp_all_gather``), the Mamba layer's ``w_in`` over ``model``
    (``tp_weight_all_gather``), serving's head gathers
    (``head_all_gather``), the attention partials' combine over the
    cache's rows (``kv_combine_all_gather``), the last rows and the
    logits (``last_row_all_gather``, ``logits_all_gather``), the loss's
    max (``tp_max_all_reduce``); in training their transposes
    (``*_grad``, ``fsdp_reduce_scatter``, ``tp_weight_reduce_scatter``)
    and the gradient sums of replicated values (``tp_all_reduce_grad``).
    An axis may be a tuple of mesh axes (``psum_pod_data``: a batch cut
    over ``pod`` and ``data``)."""

    def __init__(self):
        self.kinds: Dict[str, Dict[str, int]] = {}

    def add(self, kind: str, nbytes: int, count: int = 1) -> None:
        k = self.kinds.setdefault(kind, {"count": 0, "bytes": 0})
        k["count"] += count
        k["bytes"] += int(nbytes)

    def reset(self) -> None:
        self.kinds = {}

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {k: dict(v) for k, v in sorted(self.kinds.items())}


class _AllToAll(torch.autograd.Function):
    """:meth:`Comm.a2a` under autograd (dispatch and combine in training).
    The all-to-all of equal blocks is a permutation of the blocks over the
    group, and its transpose is the reverse exchange with the same splits,
    which is the same all-to-all: each rank's cotangent is its own part
    (the rows it sent), nothing is summed.  Synchronous both ways."""

    @staticmethod
    def forward(ctx, buf, comm, n):
        ctx.comm, ctx.n = comm, n
        out, work = comm._a2a(buf, n, False, "all_to_all")
        _wait(work)
        return out

    @staticmethod
    def backward(ctx, dout):
        dbuf, work = ctx.comm._a2a(dout.contiguous(), ctx.n, False,
                                   "all_to_all_grad")
        _wait(work)
        return dbuf, None, None


class _PSum(torch.autograd.Function):
    """:meth:`Comm.psum` under autograd.  The sum's value is replicated over
    the axis and so is every use of it (the losses every rank of the group
    computes alike), so the cotangent each rank holds is already that of
    the whole sum: the transpose gives each rank's own addend that
    cotangent unchanged.  Summing it again over the axis would count it
    once per rank."""

    @staticmethod
    def forward(ctx, flat, comm, axis):
        out = flat.clone()
        comm._all_reduce(out, axis)
        return out

    @staticmethod
    def backward(ctx, dout):
        return dout, None, None


class _Gather(torch.autograd.Function):
    """:meth:`Comm._gather` under autograd (the MoE output over ``model``,
    the rows' statistics over ``data``): ``[n, *x.shape]``, every rank's
    ``x``.  Every use of the result is replicated over the axis, so its
    cotangent is too, and the transpose is this rank's slice of it, not a
    sum (which would count it once per rank).  No collective in the
    backward."""

    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.i = comm.mesh.index(axis) if comm.mesh is not None else 0
        return comm._gather(x, axis)

    @staticmethod
    def backward(ctx, dout):
        return dout[ctx.i], None, None


class _Scatter(torch.autograd.Function):
    """This rank's slice along ``dim`` of a tensor replicated over
    ``axis`` (the MoE layer's sequence slice of its input and of the
    router's logits).  The slice's cotangent is zero outside the slice,
    so the replicated input's cotangent is the sum of every rank's piece:
    the pieces do not overlap, and the transpose is an all-gather of them
    along ``dim`` (the sum of the zero-padded pieces, exactly, with fewer
    bytes than an all-reduce)."""

    @staticmethod
    def forward(ctx, x, comm, axis, dim):
        ctx.comm, ctx.axis, ctx.dim = comm, axis, dim
        return comm._part(x, axis, dim).clone()

    @staticmethod
    def backward(ctx, dpart):
        parts = ctx.comm._gather(dpart.contiguous(), ctx.axis,
                                 "layout_all_gather_grad")
        return torch.cat(list(parts), dim=ctx.dim), None, None, None


class _FsdpGather(torch.autograd.Function):
    """The all-gather of a tensor a rank holds a slice of along ``dim``
    over ``axis`` (the FSDP gather of a weight's ``embed`` dim over
    ``data``, the reference's ``fsdp_gather``; the sequence of the
    residual over ``model`` into a column-parallel layer).  Each rank
    uses the whole tensor on its own data, so its cotangent holds that
    rank's part of the gradient: the transpose is a reduce-scatter over
    ``axis``, each rank keeping the sum over the ranks of its own slice.
    It is an all-to-all of the slices and a sum in rank order, in f32
    rounded once to the dtype, so every backend gives the same bits.
    ``kinds`` names the forward's and the transpose's census kinds."""

    @staticmethod
    def forward(ctx, w, comm, dim, axis="data",
                kinds=("fsdp_all_gather", "fsdp_reduce_scatter")):
        ctx.comm, ctx.dim, ctx.axis, ctx.kinds = comm, dim, axis, kinds
        return comm._whole(w, dim, axis, kinds[0])

    @staticmethod
    def backward(ctx, dw):
        return (ctx.comm.reduce_scatter(dw, ctx.dim, ctx.axis, ctx.kinds[1]),
                None, None, None, None)


class _ReduceScatter(torch.autograd.Function):
    """Row-parallel partial sums summed over ``axis``, this rank's slice
    along ``dim`` kept (a row-parallel layer's output back to the
    sequence-parallel residual).  The slice's cotangent is this rank's
    own; the whole partial on every rank feeds the sum, so the transpose
    is the all-gather of the slices' cotangents."""

    @staticmethod
    def forward(ctx, x, comm, dim, axis, kinds):
        ctx.comm, ctx.dim, ctx.axis, ctx.kinds = comm, dim, axis, kinds
        return comm.reduce_scatter(x, dim, axis, kinds[0])

    @staticmethod
    def backward(ctx, dy):
        return (ctx.comm._whole(dy.contiguous(), ctx.dim, ctx.axis,
                                ctx.kinds[1]), None, None, None, None)


class _Enter(torch.autograd.Function):
    """A value every rank of ``axis`` holds alike, entering computations
    that each use only a part of it (a column-parallel layer's input; a
    weight replicated over ``model`` applied to a sequence-parallel
    activation): the identity, whose transpose sums the ranks' partial
    cotangents over ``axis`` (one all-reduce), so the replicated value's
    cotangent is again the whole one on every rank."""

    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        flat = dx.reshape(-1).to(F32).contiguous()
        ctx.comm._all_reduce(flat, ctx.axis, "tp_all_reduce_grad")
        return flat.reshape(dx.shape).to(dx.dtype), None, None


class _OrderedSum(torch.autograd.Function):
    """Partial sums added over ``axis`` in rank order (an all-gather and
    sequential f32 adds, rounded once: the same bits on every rank).  The
    sum is replicated and so is every use of it, so its cotangent is the
    whole one on every rank and the transpose passes it to each addend
    unchanged (as :class:`_PSum`)."""

    @staticmethod
    def forward(ctx, x, comm, axis, kind):
        return comm._ordered_sum(x, axis, kind)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None, None


# the staged backend's host buffers: one a tensor index of a collective,
# made once by the process (pinned when the tensors are on a card: the
# copies are DMA transfers into pages that already exist); a tensor
# larger than a buffer gets fresh pageable memory.  Staged collectives
# run one at a time (the lock).
STAGING_BYTES = 1 << 30
_STAGING: Dict[int, torch.Tensor] = {}
_STAGING_LOCK = threading.Lock()


def _staging(i: int, t: torch.Tensor) -> torch.Tensor:
    """A host tensor of ``t``'s shape and dtype for the ``i``-th tensor of
    a staged collective (its contents undefined)."""
    n = t.numel() * t.element_size()
    if n > STAGING_BYTES:
        return torch.empty(t.shape, dtype=t.dtype)
    if i not in _STAGING:
        _STAGING[i] = torch.empty(STAGING_BYTES, dtype=torch.uint8,
                                  pin_memory=t.is_cuda)
    return _STAGING[i][:n].view(t.dtype).view(t.shape)


class Comm:
    """The EP group's collectives (the reference's ``Comm``).  Without a
    group (``_local_comm``) every collective is the identity over one rank.
    Over a mesh (``_dist_comm``) they run on the ``model`` group
    (``data`` for the layout's row gathers): ``psum`` is one ``all_reduce``
    of its parts packed, ``sum_in_order`` a sum in rank order over an
    all-gather, ``a2a`` an ``all_to_all_single`` over the leading ``ep``
    blocks of rows, ``all_gather_model`` an all-gather.  Under the
    ``staged`` backend each collective copies its CUDA input to the host,
    runs gloo there and copies the result back, inside a window the
    ``sentinel`` sanctions (the engine sets it).

    Training crosses ``psum``, ``a2a``, ``all_gather_model``,
    ``gather_rows``, ``scatter`` (a rank's slice of a replicated input)
    and ``fsdp_gather``: when autograd records and the input needs a
    gradient each goes through an autograd function whose backward is its
    transpose (``_PSum``, ``_AllToAll``, ``_Gather``, ``_Scatter``,
    ``_FsdpGather``; each docstring says why that transpose).  The
    convention: every rank computes the same global loss, and each rank's
    gradient is that loss's derivative with respect to what it holds, so
    a replicated value's cotangent is replicated and a value a rank holds
    in part gets the cotangent of its part.  The backward's collectives
    run on autograd's thread, in the order of the backward graph, which
    is the same on every rank."""

    def __init__(self, ep: int = 1, my_rank: int = 0, mesh=None):
        self.ep, self.my_rank = ep, my_rank
        self.mesh = mesh
        self.census = CollectiveCensus()
        self.sentinel = None          # None: no sanctioned windows

    @property
    def staged(self) -> bool:
        return self.mesh is not None and self.mesh.backend == "staged"

    def _run(self, op, tensors, outs, async_op=False):
        """``op(*tensors, async_op=...)``; returns its work (None when
        done).  Staged: the op runs on host copies (:func:`_staging`'s
        buffers) and the tensors at indices ``outs`` come back (those the
        op only writes are not copied there first).  Abstract (the dry run's mesh): nothing
        runs; the outputs keep the shapes they were made with (an
        all-to-all's and an all-reduce's those of the input, an
        all-gather's ``n`` times it, a scatter's ``1/n``)."""
        if self.mesh.backend == "abstract":
            return None
        with kcost.uncounted():
            if not self.staged:
                return op(*tensors, async_op=async_op)
            ctx = (contextlib.nullcontext() if self.sentinel is None
                   else self.sentinel.sanctioned("collective"))
            with ctx, _STAGING_LOCK:
                host = [_staging(i, t) for i, t in enumerate(tensors)]
                for i, (h, t) in enumerate(zip(host, tensors)):
                    # an output beside an input is written whole by the
                    # op: only what it reads crosses to the host (an
                    # all-reduce's one tensor is both)
                    if i not in outs or len(tensors) == 1:
                        h.copy_(t)
                op(*host, async_op=False)
                for i in outs:
                    tensors[i].copy_(host[i])
        return None

    def _tag(self, axis) -> str:
        """A census suffix for ``axis`` (a tuple: its axes on the mesh)."""
        return axis if isinstance(axis, str) else "_".join(
            self.mesh._axes(axis))

    def psum(self, parts, axis="model"):
        """Each tensor of ``parts`` (one dtype) summed over the mesh axis
        ``axis`` (the EP group by default), in one ``all_reduce`` of the
        parts packed."""
        if self.mesh is None or self.mesh.size(axis) == 1:
            return list(parts)
        flat = torch.cat([t.reshape(-1) for t in parts])
        self.census.add("psum" if axis == "model"
                        else f"psum_{self._tag(axis)}",
                        flat.nbytes, count=len(parts))
        if _records(flat):
            flat = _PSum.apply(flat, self, axis)
        else:
            self._all_reduce(flat, axis)
        out, i = [], 0
        for t in parts:
            out.append(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return out

    def _all_reduce(self, flat: torch.Tensor, axis,
                    kind: Optional[str] = None) -> None:
        import torch.distributed as dist
        self.census.add(kind or ("all_reduce" if axis == "model"
                                 else f"all_reduce_{self._tag(axis)}"),
                        flat.nbytes)
        group = self.mesh.group(axis)
        self._run(lambda t, async_op: dist.all_reduce(
            t, group=group, async_op=async_op), [flat], [0])

    def sum_over_mesh(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over every rank of the mesh in rank order (an
        all-gather over the mesh's group and sequential adds: the same bits
        on every rank), counted as ``norm_all_gather``."""
        return self._ordered_sum(x, None, "norm_all_gather")

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-dim bool ``flag`` and-ed over every rank of the mesh (one
        tiny all-reduce, counted as ``agree_all_reduce``), on ``flag``'s
        device: the ranks decide alike."""
        import torch.distributed as dist
        t = flag.to(torch.int32).reshape(1)
        self.census.add("agree_all_reduce", t.nbytes)
        group = self.mesh.group()
        self._run(lambda v, async_op: dist.all_reduce(
            v, op=dist.ReduceOp.MIN, group=group, async_op=async_op),
            [t], [0])
        return t.reshape(()) > 0

    def a2a(self, buf: torch.Tensor, n: int, async_op: bool = False):
        """Exchange the first ``n`` rows of ``buf`` (``ep`` equal blocks, the
        j-th to rank j) over the EP group: returns ``(out, work)``, ``out``
        of ``buf``'s shape with the received blocks in its first ``n`` rows
        and zeros after; ``work`` is waited on before ``out`` is read (None:
        nothing to wait for).  Without a group ``out`` is ``buf``.  Under
        autograd (``buf`` needs a gradient) it is synchronous and has its
        transpose (``_AllToAll``)."""
        if self.mesh is None:
            return buf, None
        if _records(buf):
            return _AllToAll.apply(buf, self, n), None
        return self._a2a(buf, n, async_op, "all_to_all")

    def _a2a(self, buf, n, async_op, kind):
        import torch.distributed as dist
        out = torch.zeros_like(buf)
        self.census.add(kind, buf[:n].nbytes)
        group = self.mesh.group("model")
        work = self._run(
            lambda src, dst, async_op: dist.all_to_all_single(
                dst, src, group=group, async_op=async_op),
            [buf[:n], out[:n]], [1], async_op)
        return out, work

    def sum_in_order(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the EP group in rank order, the same bits on
        every rank: an all-gather and sequential adds (the reference's
        psum of the decode combine, whose reduction order an all-reduce
        would leave to the backend)."""
        if self.mesh is None:
            return x
        self.census.add("psum", x.nbytes)
        return self._ordered_sum(x, "model", "all_gather")

    def exchange_rows(self, send: torch.Tensor, send_counts,
                      recv_counts) -> torch.Tensor:
        """Expert rows between the ranks of the EP group: ``send`` holds the
        rows for rank 0, then those for rank 1, …, ``send_counts[j]`` of them
        for rank j; returns the rows received, ``recv_counts[j]`` from rank
        j, in rank order (a mesh's group only).  The counts vary from pair
        to pair, so one ``all_to_all_single`` with split sizes moves them.
        Counted as ``migrate_all_to_all``, apart from the forward's
        collectives, with the bytes this rank sends to the others."""
        import torch.distributed as dist
        out = torch.empty((int(sum(recv_counts)),) + tuple(send.shape[1:]),
                          dtype=send.dtype, device=send.device)
        row = send[0].nbytes if send.shape[0] else out[:1].nbytes
        self.census.add("migrate_all_to_all", row * (
            int(sum(send_counts)) - int(send_counts[self.my_rank])))
        group = self.mesh.group("model")
        sc, rc = [int(n) for n in send_counts], [int(n) for n in recv_counts]
        self._run(lambda src, dst, async_op: dist.all_to_all_single(
            dst, src, rc, sc, group=group, async_op=async_op),
            [send, out], [1])
        return out

    def gather_first(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """``[ep, *x.shape]`` on the host of the EP group's first rank, each
        rank's ``x`` in rank order (None on the others; a mesh's group
        only): one ``gather``, counted as ``checkpoint_gather``.  The other
        ranks send their ``x`` and hold nothing more."""
        import torch.distributed as dist
        first = self.my_rank == 0
        dst = int(self.mesh.ranks[self.mesh.index("data"), 0])
        self.census.add("checkpoint_gather", x.nbytes)
        on_dev = self.mesh.backend == "nccl"
        ctx = (contextlib.nullcontext() if on_dev or self.sentinel is None
               else self.sentinel.sanctioned("collective"))
        with ctx:
            src = x.detach().contiguous() if on_dev \
                else x.detach().to("cpu", copy=True)
            outs = [torch.empty_like(src) for _ in range(self.ep)] \
                if first else None
            dist.gather(src, gather_list=outs, dst=dst,
                        group=self.mesh.group("model"))
            return torch.stack([o.cpu() for o in outs]) if first else None

    def agree_max(self, values) -> list:
        """Host floats, each the largest over every rank of the mesh: one
        tiny ``all_reduce``, so that every rank decides alike from figures
        it measured on its own clock."""
        import torch.distributed as dist
        dev = self.mesh.device if self.mesh.backend == "nccl" else "cpu"
        t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                         device=dev)
        self.census.add("agree_all_reduce", t.nbytes)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group())
        return t.cpu().tolist()

    def all_gather_model(self, x: torch.Tensor) -> torch.Tensor:
        """``[ep, *x.shape]``: every rank's ``x`` (the layout's gather)."""
        if _records(x):
            return _Gather.apply(x, self, "model")
        return self._gather(x, "model")

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``[rows, *x.shape]``: every data row's ``x``."""
        if _records(x):
            return _Gather.apply(x, self, ROWS)
        return self._gather(x, ROWS)

    def scatter(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` of ``x``, which every rank of
        ``axis`` holds alike (``dim`` divides over it); under autograd its
        transpose gathers the pieces (``_Scatter``)."""
        if self.mesh is None or self.mesh.size(axis) == 1:
            return x
        if _records(x):
            return _Scatter.apply(x, self, axis, dim)
        return self._part(x, axis, dim)

    def _part(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        part = x.shape[dim] // self.mesh.size(axis)
        return x.narrow(dim, self.mesh.index(axis) * part, part)

    def fsdp_gather(self, w: torch.Tensor, dim: int, axis="data",
                    kinds=("fsdp_all_gather", "fsdp_reduce_scatter")
                    ) -> torch.Tensor:
        """The whole ``dim`` of a tensor whose slice along ``dim`` each rank
        of ``axis`` holds (``_FsdpGather``; by default a weight's ``embed``
        dim over ``data``)."""
        if self.mesh is None or self.mesh.size(axis) == 1:
            return w
        if _records(w):
            return _FsdpGather.apply(w, self, dim, axis, kinds)
        return self._whole(w, dim, axis, kinds[0])

    def _whole(self, w: torch.Tensor, dim: int, axis="data",
               kind: str = "fsdp_all_gather") -> torch.Tensor:
        return torch.cat(list(self._gather(w, axis, kind)), dim=dim)

    def reduce_scatter(self, dw: torch.Tensor, dim: int, axis="data",
                       kind: str = "fsdp_reduce_scatter") -> torch.Tensor:
        """``dw`` (a whole tensor's partial sum, one a rank of ``axis``)
        summed over ``axis``, this rank's slice along ``dim`` kept: an
        all-to-all of the slices and a sum in rank order in f32, rounded
        once to ``dw``'s dtype.  Counted as ``kind`` with the bytes of
        ``dw``."""
        import torch.distributed as dist
        rows = self.mesh.size(axis)
        dim = dim % dw.dim()
        send = torch.stack(torch.chunk(dw, rows, dim=dim)).contiguous()
        recv = torch.empty_like(send)
        self.census.add(kind, send.nbytes)
        group = self.mesh.group(axis)
        self._run(lambda src, dst, async_op: dist.all_to_all_single(
            dst, src, group=group, async_op=async_op), [send, recv], [1])
        out = recv[0].to(F32)
        for part in recv[1:]:
            out = out + part.to(F32)
        return out.to(dw.dtype)

    # -- the tensor-parallel layout's collectives (models.layout) ------------
    def gather_cat(self, x: torch.Tensor, dim: int, axis="model",
                   kinds=("tp_all_gather", "tp_reduce_scatter_grad")
                   ) -> torch.Tensor:
        """Every rank's ``x`` of ``axis`` concatenated along ``dim`` in rank
        order (the sequence of the residual into a column-parallel
        layer); its transpose reduce-scatters (:class:`_FsdpGather`)."""
        return self.fsdp_gather(x, dim, axis, kinds)

    def reduce_scatter_cat(self, x: torch.Tensor, dim: int, axis="model",
                           kinds=("tp_reduce_scatter", "tp_all_gather_grad")
                           ) -> torch.Tensor:
        """Partial sums ``x`` summed over ``axis``, this rank's slice along
        ``dim`` kept (:class:`_ReduceScatter`)."""
        if self.mesh is None or self.mesh.size(axis) == 1:
            return x
        if _records(x):
            return _ReduceScatter.apply(x, self, dim, axis, kinds)
        return self.reduce_scatter(x, dim, axis, kinds[0])

    def enter(self, x: torch.Tensor, axis="model") -> torch.Tensor:
        """A replicated value entering a computation each rank of ``axis``
        does in part (:class:`_Enter`): the identity, and under autograd
        its transpose all-reduces the cotangent."""
        if self.mesh is None or self.mesh.size(axis) == 1 \
                or not _records(x):
            return x
        return _Enter.apply(x, self, axis)

    def ordered_sum(self, x: torch.Tensor, axis="model",
                    kind: str = "tp_all_reduce") -> torch.Tensor:
        """Partial sums ``x`` added over ``axis`` in rank order, the same
        bits on every rank (:class:`_OrderedSum`)."""
        if self.mesh is None or self.mesh.size(axis) == 1:
            return x
        if _records(x):
            return _OrderedSum.apply(x, self, axis, kind)
        return self._ordered_sum(x, axis, kind)

    def _ordered_sum(self, x, axis, kind):
        """The sum in rank order of every rank's ``x`` over ``axis`` (an
        all-gather counted as ``kind``), accumulated in f32 and rounded
        once to ``x``'s dtype."""
        parts = self._gather(x.contiguous(), axis, kind)
        out = parts[0].to(F32)
        for part in parts[1:]:
            out = out + part.to(F32)
        return out.to(x.dtype)

    def all_max(self, x: torch.Tensor, axis="model",
                kind: str = "tp_max_all_reduce") -> torch.Tensor:
        """The elementwise max of ``x`` over ``axis`` (no gradient: the
        loss's shift, which its value does not depend on)."""
        import torch.distributed as dist
        if self.mesh is None or self.mesh.size(axis) == 1:
            return x
        out = x.detach().contiguous().clone()
        self.census.add(kind, out.nbytes)
        group = self.mesh.group(axis)
        self._run(lambda t, async_op: dist.all_reduce(
            t, op=dist.ReduceOp.MAX, group=group, async_op=async_op),
            [out], [0])
        return out

    def _gather(self, x: torch.Tensor, axis,
                kind: str = "layout_all_gather") -> torch.Tensor:
        """``[n, *x.shape]``, every rank's ``x`` over ``axis`` (None: every
        rank of the mesh), in rank order."""
        n = 1 if self.mesh is None else self.mesh.size(axis)
        if n == 1:
            return x[None]
        import torch.distributed as dist
        # torch 2.13 renames all_gather_into_tensor (the card has 2.11)
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
        flat = x.reshape(-1).contiguous()
        out = torch.empty((n * flat.numel(),), dtype=x.dtype,
                          device=x.device)
        self.census.add(kind, flat.nbytes)
        group = self.mesh.group(axis)
        self._run(lambda src, dst, async_op: gather(
            dst, src, group=group, async_op=async_op), [flat, out], [1])
        return out.reshape(n, *x.shape)


def _records(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x``."""
    return torch.is_grad_enabled() and x.requires_grad


def _local_comm() -> Comm:
    return Comm()


def _dist_comm(mesh) -> Comm:
    """The mesh's EP-group ``Comm`` (built once, kept on the mesh)."""
    if mesh.comm is None:
        mesh.comm = Comm(mesh.size("model"), mesh.index("model"), mesh)
    return mesh.comm


def _wait(*works) -> None:
    for w in works:
        if w is not None:
            w.wait()


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(router_w: torch.Tensor, x_t: torch.Tensor, e_cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """returns (gates [t,K] f32, eidx [t,K] i32, probs [t,E] f32)."""
    return _route_logits(x_t.to(F32) @ router_w.to(F32), e_cfg)


def _route_logits(logits: torch.Tensor, e_cfg: MoEConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_route` from the router's logits."""
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = _top_k(probs, e_cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, eidx.to(torch.int32), probs


def _aux_losses(probs_sum: torch.Tensor, z_sum: torch.Tensor,
                counts_global: torch.Tensor, group_tokens: torch.Tensor,
                e_cfg: MoEConfig) -> Dict[str, torch.Tensor]:
    """GShard-style load-balance + router z losses, from the EP group's
    sums of the router probabilities and of the squared log-sum-exps."""
    e = e_cfg.num_experts
    f = counts_global / torch.clamp(group_tokens * e_cfg.top_k, min=1.0)
    p_mean = probs_sum / torch.clamp(group_tokens, min=1.0)
    lb = e * torch.sum(f * p_mean)
    z = z_sum / torch.clamp(group_tokens, min=1.0)
    return {"lb_loss": lb, "z_loss": z}


# --------------------------------------------------------------------------
# grouped expert compute (bf16 / fp4 branches)
# --------------------------------------------------------------------------
def _quantize_experts(w: Dict[str, torch.Tensor], rcfg: ReaLBConfig,
                      fi: torch.Tensor,
                      overlap_token: Optional[torch.Tensor] = None
                      ) -> Dict[str, quant.QTensor]:
    """③ on-the-fly BF16→FP4 transformation of the resident expert weights,
    under the device predicate ``fi`` (int32; nothing is computed when it
    is 0).  ``overlap_token`` (ReaLB-seq) is the reference's data
    dependency on the dispatch output, added to every ``[G,N,K]`` view
    before its global scale and quantizer: +0.0 turns a -0.0 weight into
    +0.0 (a packed code's sign bit), NaN when the dispatched tokens hold an
    inf.  The add is one more pass over the weights, made whatever ``fi``."""
    out = {}
    with kcost.branch("fp4"):
        for name, wt in w.items():
            wt_t = wt.transpose(-1, -2)
            if overlap_token is not None:
                wt_t = wt_t + overlap_token.to(wt_t.dtype)
            out[name] = kops.quantize_experts_fp4(
                wt_t, group=rcfg.group_size, pred=fi)
    return out


def _use_fp4(dec_use_fp4: torch.Tensor, ep: int, pol_ep: int,
             my_rank: int = 0) -> torch.Tensor:
    """The FP4 decision of this rank's experts as a 0-dim bool tensor on
    the device: its own entry when the policy runs over the physical EP
    group (the reference's ``dec.use_fp4[comm.my_rank]``); on one physical
    rank with a virtual policy topology, any FP4 rank switches every local
    expert."""
    if ep == pol_ep:
        return dec_use_fp4[my_rank]
    return dec_use_fp4.any()


def _expert_ffns(xs, gs, w, wq, f, fi, rcfg):
    """Both expert-FFN branches over slot-sorted rows ``xs`` with counts
    ``gs``, each with its counts masked by the decision ``f`` (``fi`` as
    int32), and the chosen one's output (the reference's ``lax.cond``)."""
    with kcost.branch("fp4"):
        y_fp4 = kops.grouped_fp4_ffn(xs, gs * fi, wq, group=rcfg.group_size)
    with kcost.branch("bf16"):
        y_bf16 = kops.grouped_ffn(xs, gs * (1 - fi), w)
    return torch.where(f, y_fp4, y_bf16)


def _per_assignment(v: torch.Tensor, k: int) -> torch.Tensor:
    """[t] → [t·k], each entry repeated k times (``repeat_interleave``
    without its host read of the output size)."""
    return v[:, None].expand(v.shape[0], k).reshape(-1)


def _route_stats(p, x_t, mod_t, val_t, m_vec, cfg, rcfg, rep, pol_ep,
                 comm: Comm, group_stats: bool, logits=None):
    """Routing, post-split loads and the policy decision (shared by both
    paths).  ``group_stats`` (dispatch): the counts, the router sums and
    the AIMD vector are summed over the EP group in one packed psum;
    ``m_vec`` is then this rank's one-hot share of it (the reference's
    psum-of-onehot).  ``slot_stat`` stays this rank's own (it packs the
    dispatch)."""
    e_cfg = cfg.moe
    e = e_cfg.num_experts
    n_slots = rep.slot_owner.shape[0]
    s_pol = n_slots // pol_ep
    t = x_t.shape[0]
    k = e_cfg.top_k
    gates, eidx, probs = _route(p["router"], x_t, e_cfg) \
        if logits is None else _route_logits(logits, e_cfg)
    flat_e = eidx.reshape(t * k)
    val_flat = _per_assignment(val_t.to(torch.bool), k)
    flat_p, secondary = _split_assignments(rep, flat_e, val_flat)
    w_val = _per_assignment(val_t.to(F32), k)
    w_vis = _per_assignment(
        (mod_t.to(torch.bool) & val_t.to(torch.bool)).to(F32), k)
    counts = _bincount(flat_e, w_val, e)
    vis = _bincount(flat_e, w_vis, e)
    slot_stat = _bincount(flat_p, w_val, n_slots)
    slot_vis = _bincount(flat_p, w_vis, n_slots)
    split = torch.sum(secondary.to(F32) * w_val)
    probs_sum = probs.sum(0)
    lse = torch.logsumexp(torch.log(torch.clamp(probs, min=1e-20)), dim=-1)
    z_sum = torch.sum(lse ** 2)
    slot_load = slot_stat
    if group_stats:
        (m_vec, counts, vis, slot_load, slot_vis, split, probs_sum,
         z_sum) = comm.psum([m_vec, counts, vis, slot_stat, slot_vis,
                             split.reshape(1), probs_sum, z_sum.reshape(1)])
        # only the router sums carry a gradient (in training)
        m_vec, counts, vis, slot_load, slot_vis = (
            t.detach() for t in (m_vec, counts, vis, slot_load, slot_vis))
        split, z_sum = split.detach().reshape(()), z_sum.reshape(())
    load_d = slot_load.reshape(pol_ep, s_pol).sum(-1)
    vis_d = slot_vis.reshape(pol_ep, s_pol).sum(-1)
    dec = realb_policy(load_d, vis_d, m_vec, rcfg)
    return dict(gates=gates, probs_sum=probs_sum, z_sum=z_sum,
                flat_p=flat_p, val_flat=val_flat, w_val=w_val,
                counts=counts, vis=vis, slot_stat=slot_stat,
                slot_load=slot_load, slot_vis=slot_vis, load_d=load_d,
                vis_d=vis_d, split=split, dec=dec)


def _aux(r, drop_frac, k, e_cfg):
    dec = r["dec"]
    total = r["load_d"].sum()
    # the reference's total / k, as XLA compiles it (f32 reciprocal)
    group_tokens = total * float(np.float32(1.0) / np.float32(max(k, 1)))
    aux = _aux_losses(r["probs_sum"], r["z_sum"], r["counts"], group_tokens,
                      e_cfg)
    aux.update(drop_frac=drop_frac, ib_global=dec.ib_global,
               fp4_ranks=dec.use_fp4.to(F32).sum(),
               load_d=r["load_d"], vis_d=r["vis_d"],
               expert_load=r["counts"], expert_vis=r["vis"],
               slot_load=r["slot_load"], slot_vis=r["slot_vis"],
               split_frac=r["split"] / torch.clamp(total, min=1.0),
               gate_open=dec.gate_open.to(F32))
    return aux


# --------------------------------------------------------------------------
# dispatch path (prefill)
# --------------------------------------------------------------------------
def _gather_weights(p, comm: Comm, fsdp: bool) -> Dict[str, torch.Tensor]:
    """The rank's expert slabs, each with its whole ``embed`` dim: under
    FSDP gathered over ``data`` (the reference's ``_gather_weights``)."""
    return {n: comm.fsdp_gather(p[n], FSDP_DIM[n]) if fsdp else p[n]
            for n in ("w_gate", "w_up", "w_down")}


def _moe_dispatch(x_t, mod_t, val_t, p, m_vec, cfg, rcfg, rep, pol_ep,
                  comm: Comm, stop_stage=None, logits=None, train=False,
                  fsdp=False):
    """x_t [t,D] this rank's tokens; mod_t [t] vision flags; val_t [t]
    real-token flags; m_vec [pol_ep] the AIMD state (under a mesh this
    rank's one-hot share of it); rep maps logical experts onto slots
    strided over ``pol_ep`` policy ranks (the EP group under a mesh; a
    virtual topology on one rank); ``p`` holds this rank's ``S/ep`` slots.

    Under ReaLB (``overlap=True``) the dispatch all-to-alls are issued,
    asynchronously, before the quantizer is launched and waited on before
    the expert GEMM: an NCCL stream waits on the compute stream as it
    stands when the collective is issued, so a quantizer launched first
    would serialise with the dispatch.  Under ReaLB-seq the quantizer runs
    after the wait, with the reference's data dependency on it.

    ``stop_stage`` (one rank only) ends the layer after the named phase
    and returns that phase's live boundary values, as the reference's
    prefixes do (the profiler's instrumented mode times each cumulative
    prefix); ``None``, the default and the last prefix, is the whole
    layer.  The ``quantize_fp4`` prefix includes the dispatch's send
    buffers, which the quantizer follows.  ``logits``: the router's
    logits of ``x_t``, when the caller computed them.

    ``train`` (the reference's): the FP4 decision is forced off, the
    quantizer never runs, and only the BF16 grouped FFN runs, through its
    autograd function (``kernels.ops.grouped_ffn``); the policy, the AIMD
    update and every statistic run as in serving.  Gradients flow through
    the gates, the router sums (``lb_loss``, ``z_loss``), the dispatch
    scatter (a dropped assignment's row lands in a spare row no one reads:
    no gradient), the expert FFN and the combine.  ``fsdp``: ``p`` holds
    the rank's ``D/data`` slice of its slabs, gathered before use."""
    e_cfg = cfg.moe
    ep = comm.ep
    n_slots = rep.slot_owner.shape[0]
    s_loc = n_slots // ep
    t, d = x_t.shape
    k = e_cfg.top_k
    dev = x_t.device

    # ① routing + metadata, ② policy
    r = _route_stats(p, x_t, mod_t, val_t, m_vec, cfg, rcfg, rep, pol_ep,
                     comm, group_stats=comm.mesh is not None, logits=logits)
    f = _use_fp4(r["dec"].use_fp4, comm.ep, pol_ep, comm.my_rank)
    if train:
        f = torch.zeros_like(f)
    if stop_stage == "route":
        return r["gates"], r["flat_p"], r["dec"].m_new, r["load_d"], f
    fi = f.to(torch.int32)
    w = _gather_weights(p, comm, fsdp)
    if stop_stage == "weight_gather":
        return r["gates"], r["flat_p"], r["dec"].m_new, f, w

    # dispatch: valid assignments first, capacity-packed by this rank's own
    # counts; padding and over-capacity assignments get the out-of-range
    # slot `big`
    flat_p, val_flat = r["flat_p"], r["val_flat"]
    dest = torch.div(flat_p, s_loc, rounding_mode="floor")
    order = torch.sort(torch.where(val_flat, dest, torch.full_like(dest, ep)),
                       stable=True).indices
    dest_s = dest[order]
    valid_s = val_flat[order]
    send_counts = r["slot_stat"].reshape(ep, s_loc).sum(-1).to(torch.int32)
    offsets = torch.cumsum(send_counts, 0, dtype=torch.int32) - send_counts
    pos_in_rank = torch.arange(t * k, dtype=torch.int32, device=dev) \
        - offsets[dest_s.long()]
    cap = max(8, -(-math.ceil(t * k / ep * e_cfg.capacity_factor) // 8) * 8)
    n_cap = ep * cap
    big = n_cap + 7                      # out of range -> dropped
    slot_s = torch.where(valid_s & (pos_in_rank < cap),
                         dest_s * cap + pos_in_rank,
                         torch.full_like(pos_in_rank, big)).long()
    tok_idx_s = torch.div(order, k, rounding_mode="floor")
    leid_s = (flat_p % s_loc)[order].to(torch.int32)
    # rows past n_cap are spare: dropped writes land there
    send = torch.zeros((n_cap + 8, d), dtype=x_t.dtype, device=dev)
    send[slot_s] = x_t[tok_idx_s]
    eid_send = torch.full((n_cap + 8,), s_loc, dtype=torch.int32,
                          device=dev)
    eid_send[slot_s] = leid_s
    slot_flat = torch.empty((t * k,), dtype=torch.long, device=dev)
    slot_flat[order] = slot_s
    recv, w_x = comm.a2a(send, n_cap, async_op=rcfg.overlap)
    eid_recv, w_e = comm.a2a(eid_send, n_cap, async_op=rcfg.overlap)

    # ③ conditional on-the-fly quantization while the dispatch is in flight
    # (ReaLB); under ReaLB-seq (overlap=False) after it, serialised by a
    # data dependency on what it received
    wq = _quantize_experts(w, rcfg, fi) if rcfg.overlap and not train \
        else None
    if stop_stage == "quantize_fp4":
        # under ReaLB-seq or train the transformation has not run here: its
        # cost lands in the dispatch prefix
        return (r["gates"], r["flat_p"], r["dec"].m_new, f,
                w if wq is None else wq)
    _wait(w_x, w_e)
    recv, eid_recv = recv[:n_cap], eid_recv[:n_cap]
    if wq is None and not train:
        token = (recv.sum() * 0.0).to(F32)
        wq = _quantize_experts(w, rcfg, fi, token)
    if stop_stage == "dispatch":
        return r["gates"], r["dec"].m_new, recv, eid_recv, slot_flat

    # ④ local expert compute; slot s_loc is the pad slot of unfilled
    # capacity rows (zeros), which has no weights: its rows give 0, as the
    # reference's zero rows through slot 0's weights do
    order2 = torch.sort(eid_recv, stable=True).indices
    xs = recv[order2]
    gs = _bincount(eid_recv, None, s_loc + 1).to(torch.int32)
    ys = kops.grouped_ffn(xs, gs, w) if train \
        else _expert_ffns(xs, gs, w, wq, f, fi, rcfg)
    y_buf = torch.zeros((n_cap + 8, d), dtype=ys.dtype, device=dev)
    y_buf[order2] = ys
    if stop_stage == "expert_gemm":
        return r["gates"], r["dec"].m_new, y_buf[:n_cap], slot_flat

    # combine: the rows go back to their senders; `big` reads a spare
    # zero row
    ret, w_y = comm.a2a(y_buf, n_cap)
    _wait(w_y)
    y_flat = ret[slot_flat]
    y_flat = torch.where((slot_flat < big)[:, None], y_flat,
                         torch.zeros((), dtype=y_flat.dtype, device=dev))
    out = torch.sum(y_flat.reshape(t, k, d)
                    * r["gates"][..., None].to(y_flat.dtype), dim=1)

    total = r["load_d"].sum()
    dropped = comm.psum([torch.sum((slot_flat >= big).to(F32)
                                   * r["w_val"]).reshape(1)])[0].reshape(())
    aux = _aux(r, dropped / torch.clamp(total, min=1.0), k, e_cfg)
    return out.to(x_t.dtype), r["dec"].m_new, aux


# --------------------------------------------------------------------------
# broadcast path (decode)
# --------------------------------------------------------------------------
def _moe_broadcast(x_t, mod_t, val_t, p, m_vec, cfg, rcfg, rep, pol_ep,
                   comm: Comm, stop_stage=None):
    """Decode-regime MoE: tokens replicated over the EP group, every local
    expert on every token, each rank's contributions summed over the group
    (the combine).  ``stop_stage``: see :func:`_moe_dispatch` (no
    ``dispatch`` phase)."""
    e_cfg = cfg.moe
    ep = comm.ep
    n_slots = rep.slot_owner.shape[0]
    s_loc = n_slots // ep
    t = x_t.shape[0]
    k = e_cfg.top_k
    dt = x_t.dtype

    if comm.mesh is not None:            # the reference's psum-of-onehot
        m_vec = comm.psum([m_vec])[0]
    # every rank sees every token: the stats need no sum over the group
    r = _route_stats(p, x_t, mod_t, val_t, m_vec, cfg, rcfg, rep, pol_ep,
                     comm, group_stats=False)
    f = _use_fp4(r["dec"].use_fp4, comm.ep, pol_ep, comm.my_rank)
    if stop_stage == "route":
        return r["gates"], r["flat_p"], r["dec"].m_new, r["load_d"], f
    fi = f.to(torch.int32)
    w = {n: p[n] for n in ("w_gate", "w_up", "w_down")}
    if stop_stage == "weight_gather":
        return r["gates"], r["flat_p"], r["dec"].m_new, f, w
    wq = _quantize_experts(w, rcfg, fi)
    if stop_stage == "quantize_fp4":
        return r["gates"], r["flat_p"], r["dec"].m_new, f, wq

    # BF16: dense per-expert products, one batch a policy rank's slab of
    # s_pol slots: the products an EP rank of that topology makes, with the
    # same batch count (a BLAS may pick its batched GEMM by it)
    s_pol = n_slots // pol_ep
    n_part = s_loc // s_pol
    ys = []
    with kcost.branch("bf16"):
        for j in range(n_part):
            sl = slice(j * s_pol, (j + 1) * s_pol)
            g = torch.matmul(x_t, w["w_gate"][sl].to(dt))    # [s_pol,t,F]
            u = torch.matmul(x_t, w["w_up"][sl].to(dt))
            h = _swiglu(g, u)
            ys.append(torch.matmul(h, w["w_down"][sl].to(dt)))  # [s_pol,t,D]
        y_bf16 = ys[0] if n_part == 1 else torch.cat(ys)
    # FP4: the grouped W4A4 kernel over x_t once per local slot (the
    # reference's decode FP4 recipe is the grouped kernel's), its counts
    # masked by the decision
    with kcost.branch("fp4"):
        xs = x_t.repeat(s_loc, 1)                             # [E·t,D]
        gs = torch.full((s_loc,), t, dtype=torch.int32,
                        device=x_t.device) * fi
        y_fp4 = kops.grouped_fp4_ffn(xs, gs, wq, group=rcfg.group_size)
    y_e = torch.where(f, y_fp4.reshape(s_loc, t, -1), y_bf16)

    pidx = r["flat_p"].reshape(t, k)                          # [t,K] placed
    leid = pidx % s_loc
    if stop_stage == "expert_gemm":
        return r["gates"], r["dec"].m_new, y_e, leid
    out = _combine_broadcast(r["gates"], pidx, leid, y_e, s_pol, comm)
    aux = _aux(r, torch.zeros((), dtype=F32, device=x_t.device), k, e_cfg)
    return out.to(dt), r["dec"].m_new, aux


def _swiglu(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``silu(g)·u`` of an expert's products, the activation evaluated in
    f32 and rounded to their dtype (the reference's ``_grouped_ffn``)."""
    return F.silu(g.to(F32)).to(g.dtype) * u


def _combine_broadcast(gates, pidx, leid, y_e, s_pol: int,
                       comm: Comm) -> torch.Tensor:
    """The decode combine: each token's gate-weighted sum of this rank's
    expert outputs ``y_e [s_loc, t, D]``, summed over the EP group in rank
    order (f32)."""
    s_loc, t = y_e.shape[:2]
    n_part = s_loc // s_pol
    dt = y_e.dtype
    sel = torch.div(pidx, s_loc, rounding_mode="floor") == comm.my_rank
    local_gate = torch.where(sel, gates, torch.zeros((), dtype=F32,
                                                     device=y_e.device))
    onehot = (leid[..., None] == torch.arange(
        s_loc, device=leid.device)).to(dt)                    # [t,K,s_loc]
    weight_e = torch.einsum("tk,tke->te", local_gate.to(dt), onehot)
    # the f32 partial sum of each slab, the partials added in rank order
    # and rounded once: the sum an EP group of the policy's size makes, one
    # slab a rank, whatever order its collective would add in
    we = weight_e.to(F32).reshape(t, n_part, s_pol)
    ye = y_e.reshape(n_part, s_pol, t, -1)
    partial = torch.einsum("te,etd->td", we[:, 0], ye[0].to(F32))
    for j in range(1, n_part):
        partial = partial + torch.einsum("te,etd->td", we[:, j],
                                         ye[j].to(F32))
    return comm.sum_in_order(partial)


# --------------------------------------------------------------------------
# public entry
# --------------------------------------------------------------------------
def ep_moe_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, rcfg: ReaLBConfig,
                   m_state: torch.Tensor,
                   modality: Optional[torch.Tensor] = None,
                   mode: str = "dispatch",
                   valid: Optional[torch.Tensor] = None,
                   placement=None, stop_stage: Optional[str] = None,
                   train: bool = False, fsdp: bool = False):
    """MoE layer with ReaLB.  x [B,S,D]; m_state [groups, ep] (see
    :func:`moe_state_shape`); valid [B,S] marks real tokens (None = all).
    ``placement``: None (identity), a :class:`Placement`, or a
    :class:`Replication` with weights ``p`` stored in the matching slot
    order.  Returns (y, new_m_state, aux_dict).

    Without a mesh (or with a ``model`` axis of 1) the policy runs over the
    trailing dim of ``m_state [1, vep]``, a virtual EP topology.  Under a
    :class:`~repro_torch.models.common.Mesh` (``use_mesh``) every rank
    passes the same global ``x``, ``m_state`` and tables and its own
    ``[S/ep]`` slots of the expert stacks; the layer returns the global
    ``y``, ``m_state`` and aux on every rank, as the reference's
    ``shard_map`` with its out-specs does.  Rows go over ``data`` when
    ``m_state`` has one group a data row (each row its own EP group),
    else every data row computes the whole batch.  In dispatch a rank
    takes its ``S/ep`` sequence slice (S must divide), in broadcast every
    token; the outputs are gathered back over ``model`` (dispatch) and
    ``data``, collectives the census classes as layout.  In the
    tensor-parallel layout of the default rules (``models.layout``) ``x``
    is this rank's rows and, in dispatch, its ``S/ep`` slice already, and
    ``y`` is returned for them; the expert stacks' ``D`` dim is gathered
    over ``data`` where the rules cut it.

    ``stop_stage`` (instrumented profiling, one rank only): end after the
    named phase (``route`` / ``weight_gather`` / ``quantize_fp4`` /
    ``dispatch`` / ``expert_gemm``) and return that prefix's raw boundary
    values instead — see :func:`repro_torch.obs.profiler.time_moe_phases`.

    ``train`` (dispatch mode): the training layer, see
    :func:`_moe_dispatch`; ``m_state`` and the statistics carry no
    gradient.  Under a mesh with ``data`` rows it takes one ``m_state``
    group a row, and ``x`` holds only this data row's rows (the training
    step keeps its rows apart for the whole step, see
    ``models.transformer.train_forward``); ``y`` is those rows.  ``fsdp``
    (the reference's): ``p``'s expert stacks hold the rank's ``D/data``
    slice of its slots (``FSDP_DIM``), all-gathered over ``data`` before
    use, the gradient reduce-scattered back (:class:`Comm`)."""
    if modality is None:
        modality = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
    if valid is None:
        valid = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    if cfg.activation != "swiglu":
        raise NotImplementedError("the expert FFN kernels are SwiGLU only")
    mesh = current_mesh()
    fn = _moe_broadcast if mode == "broadcast" else _moe_dispatch
    train = train and mode != "broadcast"
    train_kw = {"train": True} if train else {}
    b, s, d = x.shape
    tp = tensor_parallel(mesh)
    if mesh is None or (mesh.size("model") == 1 and not tp
                        and not (train and mesh.size(ROWS) > 1)):
        pol_ep = int(m_state.shape[-1]) if m_state.dim() else 1
        if cfg.moe.num_experts % pol_ep:
            raise ValueError(f"{cfg.moe.num_experts} experts over {pol_ep} "
                             "ranks")
        rep = _as_replication(placement, cfg.moe.num_experts, pol_ep,
                              x.device)
        if rep.slot_owner.shape[0] % pol_ep:
            raise ValueError(f"{rep.slot_owner.shape[0]} slots over "
                             f"{pol_ep} ranks")
        with kcost.alternatives():
            out = fn(x.reshape(b * s, d), modality.reshape(b * s),
                     valid.reshape(b * s), p, m_state.reshape(-1), cfg,
                     rcfg, rep, pol_ep, _local_comm(), stop_stage=stop_stage,
                     **train_kw)
        if stop_stage is not None:     # instrumented prefix: raw boundary
            return out
        y, m_new, aux = out
        return y.reshape(b, s, d), m_new.reshape(m_state.shape), aux

    if stop_stage is not None:
        raise NotImplementedError(
            "stop_stage instrumentation is one-rank only, as the "
            "reference's (its prefixes are local-path only); under a mesh "
            "time the forward as a whole")
    comm = _dist_comm(mesh)
    ep, rows = comm.ep, mesh.size(ROWS)
    if m_state.dim() != 2 or m_state.shape[1] != ep \
            or m_state.shape[0] not in (1, rows):
        raise ValueError(f"m_state {tuple(m_state.shape)} on a "
                         f"{rows}x{ep} mesh; see moe_state_shape")
    if train and rows > 1 and m_state.shape[0] != rows:
        raise ValueError(f"training on {rows} data rows takes one m_state "
                         f"group a row, not {tuple(m_state.shape)}: the "
                         "batch must divide over the rows (moe_state_shape)")
    rep = _as_replication(placement, cfg.moe.num_experts, ep, x.device)
    n_slots = rep.slot_owner.shape[0]
    if n_slots % ep or p["w_gate"].shape[0] != n_slots // ep:
        raise ValueError(f"{n_slots} slots over {ep} ranks: a rank holds "
                         f"{n_slots // ep} of them, not "
                         f"{p['w_gate'].shape[0]} (pass its shard)")
    if not tp:
        d_held = d // rows if fsdp else d
        if fsdp and d % rows or p["w_gate"].shape[1] != d_held \
                or p["w_down"].shape[2] != d_held:
            raise ValueError(f"expert slabs of D {p['w_gate'].shape[1]}, "
                             f"want {d_held} (fsdp={fsdp} over {rows} data "
                             "rows)")
    g = mesh.index(ROWS) if m_state.shape[0] > 1 else 0
    my = comm.my_rank
    m_part = (torch.arange(ep, device=x.device) == my).to(F32) \
        * m_state[g, my].to(F32)
    kw = {"fsdp": fsdp} if train else {}
    if tp:
        # the tensor-parallel layout (models.layout): ``x`` is the rank's
        # rows and, in dispatch, its S/ep slice of the sequence already;
        # the expert stacks' D dim (``embed`` over data) is gathered on
        # use in serving too (the reference's GSPMD gathers them into its
        # shard_map), its transpose reduce-scattering the gradient
        xl, mod_l, val_l = x, modality, valid
        p = {**p, **{n: comm.fsdp_gather(p[n], FSDP_DIM[n])
                     if p[n].shape[FSDP_DIM[n]] < d else p[n]
                     for n in ("w_gate", "w_up", "w_down")}}
        if train:
            kw["fsdp"] = False
    else:
        # rows over data (one EP group a row; in training the caller
        # passes them), the dispatch's sequence over model
        cut_b = local_slice(b, "batch", mesh) if m_state.shape[0] > 1 \
            and not train else slice(0, b)
        if mode != "broadcast" and s % ep:
            raise ValueError(f"a seq dim of {s} does not divide over the "
                             f"{ep} ranks of the mesh's 'model' axis")
        cut_s = slice(0, s) if mode == "broadcast" \
            else local_slice(s, "seq", mesh)
        xb = x[cut_b]
        xl = xb if mode == "broadcast" else comm.scatter(xb, "model", 1)
        mod_l, val_l = modality[cut_b, cut_s], valid[cut_b, cut_s]
        if mode != "broadcast":
            # the router's logits of the group's whole sequence, this
            # rank's slice kept: a BLAS picks its f32 GEMM by the row
            # count, so logits of a slice could differ in the last bit
            # from the one-device layer's and flip a near-tie of the top-k
            kw["logits"] = comm.scatter(
                (xb.reshape(-1, d).to(F32) @ p["router"].to(F32))
                .reshape(xb.shape[0], s, -1), "model", 1).reshape(
                    xl.shape[0] * xl.shape[1], -1)
    bl, sl = xl.shape[:2]
    with kcost.alternatives():
        y, m_new, aux = fn(xl.reshape(bl * sl, d), mod_l.reshape(bl * sl),
                           val_l.reshape(bl * sl), p, m_part,
                           cfg, rcfg, rep, ep, comm, **train_kw, **kw)
    y = y.reshape(bl, sl, d)
    if mode != "broadcast" and not tp:
        y = comm.all_gather_model(y).permute(1, 0, 2, 3).reshape(bl, s, d)
    scal = torch.stack([aux[n].to(F32).reshape(()) for n in AUX_SCALARS])
    stats = torch.stack([aux["load_d"], aux["vis_d"]])          # [2, ep]
    estats = torch.stack([aux["expert_load"], aux["expert_vis"]])
    sstats = torch.stack([aux["slot_load"], aux["slot_vis"]])
    if m_state.shape[0] == 1:
        m_out = m_new.reshape(1, ep)
        scal, stats, estats, sstats = (scal[None], stats[None],
                                       estats[None], sstats[None])
    else:                                # every row's values, by row
        if not train and not tp:
            y = comm.gather_rows(y).reshape(b, s, d)
        packed = comm.gather_rows(torch.cat([
            m_new.reshape(-1), scal, stats.reshape(-1), estats.reshape(-1),
            sstats.reshape(-1)]))
        sizes = (ep, scal.numel(), stats.numel(), estats.numel(),
                 sstats.numel())
        m_out, scal, stats, estats, sstats = (
            v.reshape(rows, *shape) for v, shape in zip(
                torch.split(packed, sizes, dim=1),
                ((ep,), (scal.numel(),), stats.shape, estats.shape,
                 sstats.shape)))
        m_out, stats, estats, sstats = (
            t.detach() for t in (m_out, stats, estats, sstats))
    aux_mean = scal.mean(0)
    out = {n: aux_mean[i] for i, n in enumerate(AUX_SCALARS)}
    out.update(load_d=stats[:, 0], vis_d=stats[:, 1],
               expert_load=estats[:, 0].sum(0), expert_vis=estats[:, 1].sum(0),
               slot_load=sstats[:, 0].sum(0), slot_vis=sstats[:, 1].sum(0))
    return y, m_out.reshape(m_state.shape), out


def moe_state_shape(mesh=None, global_batch: int = 1,
                    virtual_ep: Optional[int] = None) -> Tuple[int, int]:
    """AIMD M-state shape ``[n_groups, ep]`` for a mesh and a batch: one
    group a data row when the batch divides over them (each row is its own
    EP group), else one replicated group.  Without a mesh ``[1, vep]``,
    the policy's virtual EP topology (``virtual_ep``, default 1)."""
    if mesh is None:
        return (1, int(virtual_ep) if virtual_ep else 1)
    rows, ep = mesh.size(ROWS), mesh.size("model")
    if global_batch % max(rows, 1):
        rows = 1
    return (rows, ep)

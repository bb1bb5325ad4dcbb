"""Op-level cost analysis of one step, on any device.

Counterpart of ``repro.launch.hlo_analysis``, which walks a compiled
module's HLO.  An eager port has no module: :class:`OpAnalyzer`, a
``TorchDispatchMode``, sees every aten op a step dispatches, on the CPU,
on ``meta`` (the dry run) or on the card, and accounts:

* **flops** — every matmul-family op (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``mv``, ``addmv``, ``dot``) at 2·M·N·K, and every kernel
  of the port at its own formula (``kernels.cost``), reported by its entry
  in ``kernels.ops``; the ops the kernel's plain version dispatches inside
  the entry are not counted;
* **traffic** — the bytes in and out of every op that makes or writes a
  tensor (inputs once, outputs that are not an input once; a kernel its
  formula's bytes).  Views, reshapes and other aliasing or metadata ops
  and bare allocations are free, as ``hlo_analysis`` counts only ops that
  materialise;
* **peak live bytes** — the step's arguments (:meth:`track`) plus every
  storage an op makes, from its making until it dies.  Storages are keyed
  by their ``StorageImpl`` (on ``meta`` every ``data_ptr`` is 0) and
  dropped by a finalizer when the last tensor on them dies.  A kernel adds
  its formula's scratch for the time of its launch; what an aten op
  allocates inside itself (a sort's buffers, cuBLAS's workspace) is not
  seen;
* **collectives** — the bytes of the active mesh's ``Comm`` census
  (``core.ep_moe``), by kind.  ``psum`` kinds count the reference's psums,
  which the port packs into the ``all_reduce`` that carries them: they
  are listed but not added to the collective bytes;
* **top traffic** (by op and the port function that dispatched it) and
  **top collectives** (by kind).

The branch rule: inside ``kernels.cost.alternatives()`` (one MoE layer)
the work of each ``kernels.cost.branch`` (the BF16 path, and the FP4 path
of quantizer and W4A4 FFN) is summed apart and the larger is priced, never
the sum, as ``hlo_analysis`` prices a ``conditional``'s branches.  The
peak counts what is allocated, both branches' buffers included, since
both launch.

Every count depends only on the ops and the shapes, so the same step gives
the same flops, traffic, peak and census on the CPU, on ``meta`` and on the
card.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import cost, ops

aten = torch.ops.aten

# ops that allocate without reading or writing (their storage counts live)
_ALLOC = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
          aten.new_empty_strided}
# census kinds that name the reference's collectives, carried by others
_LOGICAL = ("psum",)
_HERE = (__file__, cost.__file__, ops.__file__)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(tree: Any, exclude: Any = ()) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors, those of
    ``exclude``'s tensors left out."""
    skip = {_key(t) for t in tree_leaves(exclude)
            if isinstance(t, torch.Tensor)}
    seen: Dict[int, int] = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor) and _key(t) not in skip:
            seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


def matmul_flops(func, args, out) -> float:
    """2·M·N·K of a matmul-family aten op (0 for any other op)."""
    pk = func.overloadpacket
    if pk in (aten.mm, aten.bmm):
        return 2.0 * out.numel() * args[0].shape[-1]
    if pk in (aten.addmm, aten.baddbmm):
        return 2.0 * out.numel() * args[1].shape[-1]
    if pk is aten.mv:
        return 2.0 * args[0].numel()
    if pk is aten.addmv:
        return 2.0 * args[1].numel()
    if pk in (aten.dot, aten.vdot):
        return 2.0 * args[0].numel()
    return 0.0


def where() -> str:
    """``module.function`` of the innermost frame of the port on the
    Python stack outside this module and the kernel entries
    (``kernels.cost``, ``kernels.ops``): the port's counterpart of a jax
    name stack's leaf."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if "repro_torch" in name and name not in _HERE:
            return f"{f.f_globals.get('__name__', '?')}.{f.f_code.co_name}"
        f = f.f_back
    return "?"


class _Alternatives:
    """One :func:`kernels.cost.alternatives` scope: work by branch."""

    def __init__(self, an: "OpAnalyzer"):
        self.an = an
        self.buckets: Dict[str, List[float]] = {}
        self.cur: Optional[str] = None

    def __enter__(self):
        self.an._alts.append(self)
        return self

    def __exit__(self, *exc):
        self.an._alts.pop()
        if self.buckets:
            self.an._add(max(b[0] for b in self.buckets.values()),
                         max(b[1] for b in self.buckets.values()))
        return False


class _Branch:
    def __init__(self, an: "OpAnalyzer", name: str):
        self.an, self.name, self.prev, self.scope = an, name, None, None

    def __enter__(self):
        if self.an._alts:
            self.scope = self.an._alts[-1]
            self.prev, self.scope.cur = self.scope.cur, self.name
        return self

    def __exit__(self, *exc):
        if self.scope is not None:
            self.scope.cur = self.prev
        return False


class OpAnalyzer(TorchDispatchMode):
    """Counts a step's work while entered (see the module docstring).
    ``mesh``: whose ``Comm`` census to read (default: none); ``track`` the
    step's arguments before running it so that they count live."""

    def __init__(self, mesh=None):
        super().__init__()
        self.mesh = mesh
        self.flops = 0.0
        self.traffic = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.by_op: Dict[tuple, List[float]] = defaultdict(lambda: [0, 0])
        self.census: Dict[str, Dict[str, int]] = {}
        self._paused = 0
        self._alts: List[_Alternatives] = []
        self._bytes: Dict[int, int] = {}
        self._fins: Dict[int, weakref.finalize] = {}
        self._census0: Dict[str, Dict[str, int]] = {}
        self._prev = None

    # -- enter / exit ----------------------------------------------------
    def __enter__(self):
        if self.mesh is not None:
            from repro_torch.core.ep_moe import _dist_comm
            self._census0 = _dist_comm(self.mesh).census.snapshot()
        self._prev = cost.set_analyzer(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        cost.set_analyzer(self._prev)
        if self.mesh is not None:
            from repro_torch.core.ep_moe import _dist_comm
            now = _dist_comm(self.mesh).census.snapshot()
            self.census = {}
            for kind, v in now.items():
                v0 = self._census0.get(kind, {"count": 0, "bytes": 0})
                d = {"count": v["count"] - v0["count"],
                     "bytes": v["bytes"] - v0["bytes"]}
                if d["count"]:
                    self.census[kind] = d
        for fin in self._fins.values():
            fin.detach()
        self._fins.clear()
        return out

    # -- liveness --------------------------------------------------------
    def _register(self, t: torch.Tensor, nbytes: int) -> bool:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._bytes:
            return False
        self._bytes[key] = nbytes
        self._fins[key] = weakref.finalize(st, self._free, key)
        self.live += nbytes
        if self.live > self.peak:
            self.peak = self.live
        return True

    def _free(self, key: int) -> None:
        self.live -= self._bytes.pop(key, 0)
        self._fins.pop(key, None)

    def track(self, tree: Any) -> int:
        """Count the tensors of ``tree`` (a step's arguments) live as its
        arguments; returns their bytes."""
        n = 0
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                nb = t.untyped_storage().nbytes()
                if self._register(t, nb):
                    n += nb
        self.argument_bytes += n
        return n

    # -- counting --------------------------------------------------------
    def _add(self, flops: float, traffic: int) -> None:
        for scope in reversed(self._alts):
            if scope.cur is not None:
                b = scope.buckets.setdefault(scope.cur, [0.0, 0])
                b[0] += flops
                b[1] += traffic
                return
        self.flops += flops
        self.traffic += traffic

    def alternatives(self) -> _Alternatives:
        return _Alternatives(self)

    def branch(self, name: str) -> _Branch:
        return _Branch(self, name)

    def kernel(self, works, fn, args, kw):
        """A kernel entry (``kernels.cost.run``): ``fn`` runs uncounted,
        then each launch's :class:`~repro_torch.kernels.cost.Work`; its
        outputs count live from here, its scratch during the launch."""
        self._paused += 1
        try:
            out = fn(*args, **kw)
            ws = works()
        finally:
            self._paused -= 1
        temp = 0
        for name, w in ws.items():
            k = self.kernels.setdefault(
                name, {"launches": 0, "flops": 0.0, "bytes": 0})
            k["launches"] += 1
            k["flops"] += w.flops
            k["bytes"] += w.nbytes
            self._add(w.flops, w.nbytes)
            rec = self.by_op[(f"kernel:{name}", where())]
            rec[0] += w.nbytes
            rec[1] += 1
            temp += w.temp
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._register(t, _nbytes(t))
        self.peak = max(self.peak, self.live + temp)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        self.n_ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.is_view:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        in_keys = {_key(t) for t in ins}
        fresh = [t for t in outs if _key(t) not in in_keys]
        if func.overloadpacket in _ALLOC:
            for t in fresh:
                self._register(t, t.untyped_storage().nbytes())
            return out
        if outs and not fresh and not func._schema.is_mutable:
            return out           # aliases its input (_unsafe_view, alias)
        traffic = sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs if not any(t is i for i in ins))
        flops = matmul_flops(func, args, outs[0]) if outs else 0.0
        self._add(flops, traffic)
        rec = self.by_op[(str(func.overloadpacket.__name__), where())]
        rec[0] += traffic
        rec[1] += 1
        for t in fresh:
            self._register(t, t.untyped_storage().nbytes())
        return out

    # -- results ---------------------------------------------------------
    def collective_bytes(self) -> int:
        return sum(v["bytes"] for k, v in self.census.items()
                   if not k.startswith(_LOGICAL))

    def top_traffic(self, n: int = 10) -> List[Dict[str, Any]]:
        rows = [{"op": op, "where": w, "bytes": int(b), "count": int(c)}
                for (op, w), (b, c) in self.by_op.items()]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:n]

    def top_collectives(self, n: int = 8) -> List[Dict[str, Any]]:
        rows = [{"op": k, "bytes": v["bytes"], "count": v["count"]}
                for k, v in self.census.items()]
        rows.sort(key=lambda r: -r["bytes"])
        return rows[:n]

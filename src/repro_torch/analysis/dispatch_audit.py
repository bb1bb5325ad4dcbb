"""Dispatch-time audit of a forward's aten ops, and its collective census
against the ledger's prediction.

Counterpart of ``repro.analysis.jaxpr_audit``, which walks a traced
step's jaxpr.  An eager port has no jaxpr: :class:`DispatchAudit`, a
``TorchDispatchMode``, sees every aten op a forward dispatches (on the
CPU, on ``meta`` or on the card) and flags what the reference flags:

* **host round trips** — ``aten._local_scalar_dense`` (``.item()``,
  ``bool()``, ``int()`` of a tensor), a copy of a device tensor to the
  CPU, and an op whose output's shape depends on the data (``nonzero``,
  ``masked_select``, ``unique``, indexing by a mask...), which must read
  the device: each serializes the step on the host (the reference's host
  callbacks);
* **f64** — a float64 or complex128 tensor in or out of any op, outside
  ``F64_ALLOWLIST``;
* **widenings** — a float op whose output is wider than a float input
  (bf16→f32, anything→f64), explicit (``.to``) or by promotion, inside
  the MoE layer's dispatch and expert phases (``WIDEN_SCOPES``) and not
  in a function below the phase whose name holds one of the reference's
  allowlist words (``DEFAULT_WIDEN_ALLOWLIST``).  Sub-byte and 8-bit
  sources are always allowed (the FP4 dequant).  A widening in a
  function of ``KNOWN_WIDENINGS`` is the reference's algorithm that its
  own rule would flag: it is no violation but is listed in
  :attr:`AuditReport.known`, whose length the tests and the smoke hold.

Where the reference matches a ``jax.named_scope`` name stack, the audit
matches the names of the port's functions on the Python stack, outermost
first, joined by ``/`` (``..._run_stack/apply_layer/_ffn_part/
ep_moe_forward/_moe_dispatch/_route_stats``): the route and policy
steps run in ``_route``/``_route_stats``, the decode combine in
``_combine_broadcast``, the quantizer in ``_quantize_experts`` and the
expert FFNs in ``_expert_ffns`` (kernels) or, decoding in BF16, as
products and ``_swiglu``.  A phase is matched by the exact name of its
function, and the allowlist words only in the functions it calls, so
that no name above the MoE layer changes what the audit lets through.
A kernel entry (``kernels.cost.run``) is one launch on the card: the ops
of its plain version on the CPU are not audited.

:func:`census_matches_prediction` holds the abstract mesh's ``Comm``
census of a prefill (``launch.steps.lower_cell``) against
``obs.ledger.FlopByteLedger.predict_graph_census``: the reference's
reconciliation is three-way (jaxpr, HLO, ledger), the port's two-way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import cost

aten = torch.ops.aten

#: phases where a float widening is the algorithm: the reference's words
#: (f32 softmax and logits in route, f32 gate accumulation in combine,
#: f32 norm statistics, attention softmax, aux losses), matched in the
#: functions that a phase of ``WIDEN_SCOPES`` calls
DEFAULT_WIDEN_ALLOWLIST = ("route", "combine", "norm", "attention", "aux",
                           "softmax", "rope", "embed", "logits")
#: the MoE layer's dispatch and expert phases, by function name
WIDEN_SCOPES = ("_moe_dispatch", "_moe_broadcast", "_quantize_experts",
                "_expert_ffns")
#: widenings of the reference's algorithm that its rule flags on a bf16
#: model, by the function that makes them: the BF16 decode experts'
#: activation, ``silu(g.astype(f32))`` under the reference's
#: ``expert_gemm`` scope (``repro.core.ep_moe``), one bf16→f32 per slab
#: of products (the kernels do it inside, unseen)
KNOWN_WIDENINGS = ("_swiglu",)
#: functions where f64 is the algorithm: RoPE's inverse frequencies,
#: a [head_dim/2] vector evaluated in f64 and rounded once to f32 (XLA's
#: f32 pow is correctly rounded, torch's is not; ``models.common``)
F64_ALLOWLIST = ("rope_freqs",)
_DATA_SHAPED = {aten.nonzero, aten.masked_select, aten._unique,
                aten._unique2, aten.unique_dim, aten.unique_consecutive,
                aten.unique_dim_consecutive, aten.masked_scatter}
_F64 = (torch.float64, torch.complex128)


@dataclasses.dataclass
class AuditViolation:
    kind: str            # host_sync | data_shape | f64 | widening
    op: str
    where: str           # the port's function stack
    detail: str

    def format(self) -> str:
        return f"[{self.kind}] {self.op} @ {self.where}: {self.detail}"


@dataclasses.dataclass
class AuditReport:
    violations: List[AuditViolation]
    n_ops: int
    widenings: List[Dict[str, Any]]     # every float widening seen
    known: List[Dict[str, Any]]         # those in KNOWN_WIDENINGS
    f64_allowed: int                    # f64 ops on F64_ALLOWLIST

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> Dict[str, Any]:
        return {"ok": self.ok, "n_ops": self.n_ops,
                "violations": [dataclasses.asdict(v)
                               for v in self.violations],
                "widenings": self.widenings, "known": self.known,
                "f64_allowed": self.f64_allowed}


def _float_bits(dtype: torch.dtype) -> Optional[int]:
    if not dtype.is_floating_point:
        return None
    return torch.finfo(dtype).bits


def function_stack() -> str:
    """The port's functions on the Python stack, outermost first."""
    names = []
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and "/analysis/" not in fn \
                and fn != cost.__file__:
            names.append(f.f_code.co_name)
        f = f.f_back
    return "/".join(reversed(names))


class DispatchAudit(TorchDispatchMode):
    """Audits the aten ops dispatched while entered; :meth:`report` after."""

    def __init__(self):
        super().__init__()
        self.violations: List[AuditViolation] = []
        self.widenings: List[Dict[str, Any]] = []
        self.known: List[Dict[str, Any]] = []
        self.n_ops = 0
        self.f64_allowed = 0
        self._paused = 0
        self._prev = None

    def __enter__(self):
        self._prev = cost.set_analyzer(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        cost.set_analyzer(self._prev)
        return out

    # the kernels.cost hook: a kernel entry is one launch, not audited
    def kernel(self, works, fn, args, kw):
        self._paused += 1
        try:
            return fn(*args, **kw)
        finally:
            self._paused -= 1

    def alternatives(self):
        return contextlib.nullcontext()

    def branch(self, name: str):
        return contextlib.nullcontext()

    def _flag(self, kind, func, stack, detail):
        self.violations.append(AuditViolation(kind, str(func), stack,
                                              detail))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        self.n_ops += 1
        stack = function_stack()
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        pk = func.overloadpacket
        # host round trips, flagged before the op runs (meta refuses it)
        if pk is aten._local_scalar_dense:
            self._flag("host_sync", func, stack,
                       "reads a device value on the host (.item(), bool(), "
                       "int() of a tensor)")
        elif pk in _DATA_SHAPED or (
                pk in (aten.index, aten.index_put, aten.index_put_)
                and any(t.dtype in (torch.bool, torch.uint8)
                        for t in ins[1:])):
            self._flag("data_shape", func, stack,
                       "its output's shape depends on the data")
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(o.device.type == "cpu" for o in outs) and any(
                i.device.type not in ("cpu", "meta") for i in ins):
            self._flag("host_sync", func, stack,
                       "copies a device tensor to the CPU")
        if any(t.dtype in _F64 for t in ins + outs):
            if stack.rsplit("/", 1)[-1] in F64_ALLOWLIST:
                self.f64_allowed += 1
            else:
                self._flag("f64", func, stack, "float64 value")
        self._widening(func, stack, ins, outs)
        return out

    def _widening(self, func, stack, ins, outs):
        dst = [o.dtype for o in outs if o.dtype.is_floating_point]
        if not dst or func.is_view:
            return
        db = max(_float_bits(d) for d in dst)
        srcs = {t.dtype for t in ins if t.dtype.is_floating_point
                and t.dim() > 0}
        for src in srcs:
            sb = _float_bits(src)
            if sb >= db:
                continue
            d = next(x for x in dst if _float_bits(x) == db)
            entry = {"src": str(src), "dst": str(d), "op": str(func),
                     "where": stack}
            self.widenings.append(entry)
            if db == 64:
                self._flag("widening", func, stack, f"{src} -> {d}")
                continue
            frames = stack.split("/")
            scope = next((i for i, n in enumerate(frames)
                          if n in WIDEN_SCOPES), None)
            if scope is None or sb <= 8 or any(
                    a in n for n in frames[scope + 1:]
                    for a in DEFAULT_WIDEN_ALLOWLIST):
                continue
            if frames[-1] in KNOWN_WIDENINGS:
                self.known.append(entry)
                continue
            self._flag("widening", func, stack,
                       f"{src} -> {d} widening on the MoE dispatch/expert "
                       "path is not on the allowlist")

    def report(self) -> AuditReport:
        return AuditReport(list(self.violations), self.n_ops,
                           list(self.widenings), list(self.known),
                           self.f64_allowed)


def audit(fn, *args, **kw) -> AuditReport:
    """Run ``fn(*args, **kw)`` under a default :class:`DispatchAudit`."""
    with DispatchAudit() as a:
        fn(*args, **kw)
    return a.report()


def census_matches_prediction(cfg, batch: int, seq: int, mesh
                              ) -> Dict[str, Any]:
    """One prefill of ``[batch, seq]`` on ``meta`` under the abstract
    ``mesh`` (``launch.steps.lower_cell``): its ``Comm`` census beside
    ``predict_graph_census`` for its MoE layers (each rank dispatches its
    rows' ``seq/ep`` tokens; in the tensor-parallel layout of the rules in
    force, every collective of the forward, ``layout=``).  ``{"census",
    "predicted", "ok"}``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.ep_moe import moe_state_shape
    from repro_torch.launch.steps import lower_cell
    from repro_torch.models.common import DTYPES, tensor_parallel
    from repro_torch.obs.ledger import FlopByteLedger
    rows, ep = moe_state_shape(mesh, batch)
    rec = lower_cell(cfg, ShapeConfig("census", seq, batch, "prefill"), mesh)
    n_moe = sum(1 for f in cfg.ffn_kinds() if f == "moe")
    layout = dict(mesh=mesh, mode="prefill", batch=batch, seq=seq) \
        if tensor_parallel(mesh) else None
    pred = FlopByteLedger(cfg, ep=ep).predict_graph_census(
        t_local=(batch // rows) * (seq // ep), layers=n_moe,
        itemsize=DTYPES[cfg.param_dtype].itemsize, rows=rows, layout=layout)
    return {"census": rec["census"], "predicted": pred,
            "ok": rec["census"] == pred}

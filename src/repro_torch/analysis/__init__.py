"""repro_torch.analysis — the serving hot loop's invariant checkers.

Counterpart of ``repro.analysis``, in three layers:

* :mod:`repro_torch.analysis.lint` — AST lint of the port (RPL003–RPL007,
  the reference's rules, scoping, suppression comment and CLI; RPL001 and
  RPL002 are checked at run time, by the sentinel and the audit).
* :mod:`repro_torch.analysis.dispatch_audit` — the counterpart of the
  reference's jaxpr audit: every aten op a forward dispatches, with no host
  round trip, no f64 and no unlisted float widening on the MoE dispatch
  and expert path; and the abstract mesh's collective census held against
  the ledger's prediction.
* :mod:`repro_torch.analysis.sentinel` — guards the engine's iteration
  window against device→host syncs (method patches on ``torch.Tensor``
  and, on a card, ``torch.cuda``'s sync debug mode) and counts the input
  signatures of its entry points.

Exports are loaded lazily, as the reference loads its sentinel.
"""

__all__ = ["Sentinel", "NULL_SENTINEL", "SyncViolation",
           "Finding", "lint_paths", "lint_source",
           "AuditViolation", "DispatchAudit", "audit"]

_LAZY = {"Sentinel": "sentinel", "NULL_SENTINEL": "sentinel",
         "SyncViolation": "sentinel", "Finding": "lint",
         "lint_paths": "lint", "lint_source": "lint",
         "AuditViolation": "dispatch_audit",
         "DispatchAudit": "dispatch_audit", "audit": "dispatch_audit"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"repro_torch.analysis.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(name)

"""repro_torch.analysis — the serving hot loop's invariant checker.

Counterpart of ``repro.analysis``: :mod:`repro_torch.analysis.sentinel`
guards the engine's iteration window against device→host syncs (method
patches on ``torch.Tensor`` and, on a card, ``torch.cuda``'s sync debug
mode) and counts the input signatures of its entry points.  The
reference's AST lint (``repro.analysis.lint``) is not ported yet; its
jaxpr audit has no counterpart in an eager port.  Exports are loaded
lazily, as the reference loads its sentinel.
"""

__all__ = ["Sentinel", "NULL_SENTINEL", "SyncViolation"]


def __getattr__(name):
    if name in __all__:
        from repro_torch.analysis import sentinel
        return getattr(sentinel, name)
    raise AttributeError(name)

"""Runtime sentinel — the serving hot loop's invariant checker.

Counterpart of ``repro.analysis.sentinel``.  Two properties that no
functional test catches when they regress:

* **Device→host syncs.**  A stray ``.item()`` or ``bool(t)`` inside an
  iteration blocks the host until the card has caught up and serializes
  dispatch.  Inside :meth:`Sentinel.hot` the sentinel patches the host
  pulls of ``torch.Tensor`` — ``item``, ``tolist``, ``numpy`` (and so
  ``np.asarray``), ``__bool__``, ``__int__``, ``__float__``,
  ``__index__``, and ``.cpu()`` / ``.to("cpu")`` of a CUDA tensor — on
  any tensor, as the reference patches the jax Array's pull seam whatever
  the backend; the patches come off when the window closes.  On a card it
  also arms ``torch.cuda.set_sync_debug_mode`` ("error" when ``strict``,
  else "warn" with each warning recorded as a violation at its site),
  which catches the syncs torch makes inside an op (``nonzero``, boolean
  indexing, a blocking upload) that no method patch sees.  Sanctioned
  pull sites (sampling, the statistics read) open :meth:`sanctioned`;
  anything else is recorded as a violation, or raised under ``strict``.

  Collectives under a mesh: an NCCL collective (``all_reduce``,
  ``all_to_all_single``, an all-gather) is enqueued on NCCL's stream, which
  waits on the compute stream, and ``work.wait()`` makes the compute
  stream wait in turn; neither reads the device on the host, so an EP
  forward under NCCL runs under ``set_sync_debug_mode("error")`` with no
  sync.  The ``staged`` backend (several ranks on one card) copies each
  collective's tensors to the host and back: those copies run inside
  :meth:`sanctioned` windows labelled ``collective`` (the engine hands its
  sentinel to the mesh's ``Comm``), so they are counted, not violations.

  A kernel's plain version (``repro_torch/kernels``) stands in for the
  kernel on the CPU and reads its own CPU inputs there (a predicate, a
  group count); those reads are not violations.  On a card no CPU tensor
  reaches them, and a pull of a CUDA tensor there is one.

* **New shapes after warm-up.**  A jit compiles once per input signature;
  the eager port has no compiler, so the counterpart of the reference's
  per-entry compile count is the number of distinct input signatures
  (shape, dtype and device of every tensor argument, and the value of
  every static one, such as the config) an entry has been called with:
  what a jit, or a CUDA-graph capture, would build a program for.
  :meth:`register_entry` wraps an entry point so it counts them; after
  :meth:`mark_warm` every new signature is reported.  A deliberate
  rebuild (the capacity-resize band) is declared with :meth:`note_rebuild`.
  Where the engine captures its chunk and decode forwards as CUDA graphs
  (``serving/graphs.py``), those entries count captures instead: each
  distinct key a graph was captured for (:meth:`note_capture`), so "new
  signatures after warm-up" reads "new captures after warm-up"; a key
  captured again after a declared rebuild dropped the graphs is a
  recapture, counted apart.  :meth:`note_step` records how the engine
  runs its forwards (graphed, or eager and why), and the report
  says it.

:data:`NULL_SENTINEL` is the tracer's null object: ``enabled`` is False,
its windows are shared no-ops, and an engine without a sentinel gives the
same outputs bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Set

import torch

__all__ = ["Sentinel", "NULL_SENTINEL", "SyncViolation"]

_SYNC_MSG = "synchronizing CUDA operation"
# host pulls of any tensor, and pulls that only a CUDA tensor makes
_PULLS = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__",
          "__index__")
_CUDA_PULLS = ("cpu", "to")
_SKIP = ("repro_torch/analysis", "/torch/", "/warnings.py")


@dataclasses.dataclass
class SyncViolation:
    where: str          # python source "file:line (function)"
    context: str        # engine phase label if known
    kind: str = "host_sync"


def _frames():
    f = sys._getframe(2)
    while f is not None:
        yield f
        f = f.f_back


def _caller_site() -> str:
    """The first frame outside the sentinel and torch."""
    for f in _frames():
        fn = f.f_code.co_filename.replace("\\", "/")
        if not any(p in fn for p in _SKIP):
            return f"{fn}:{f.f_lineno} ({f.f_code.co_name})"
    return "<unknown>"


def _in_plain_kernel() -> bool:
    """Whether the nearest caller outside torch is a kernel's plain
    version (``repro_torch/kernels``)."""
    for f in _frames():
        fn = f.f_code.co_filename.replace("\\", "/")
        if any(p in fn for p in _SKIP):
            continue
        return "repro_torch/kernels/" in fn
    return False


def _targets_cpu(args, kwargs) -> bool:
    """Whether a ``Tensor.to`` call moves the tensor to the CPU."""
    dev = kwargs.get("device")
    if dev is None and args:
        a = args[0]
        if isinstance(a, torch.Tensor):
            dev = a.device
        elif isinstance(a, (str, torch.device)):
            dev = a
    return dev is not None and torch.device(dev).type == "cpu"


class _HostPullGuard:
    """Class-level patches on ``torch.Tensor``'s host pulls with
    thread-local hot/sanctioned depths; reference-counted, so nested
    windows and an armed sentinel share one installation."""

    def __init__(self, on_violation: Callable[[], None]):
        self._on_violation = on_violation
        self._tls = threading.local()
        self._installs = 0

    def _depth(self, name: str) -> int:
        return getattr(self._tls, name, 0)

    def _bump(self, name: str, d: int) -> None:
        setattr(self._tls, name, self._depth(name) + d)

    def _guarded(self) -> bool:
        return self._depth("hot") > 0 and self._depth("sanctioned") == 0

    def _wrap(self, name: str):
        orig = getattr(torch._C.TensorBase, name)
        guard = self

        if name == "cpu":
            def pull(t, *a, **kw):
                if t.is_cuda and guard._guarded():
                    guard._on_violation()
                return orig(t, *a, **kw)
        elif name == "to":
            def pull(t, *a, **kw):
                if t.is_cuda and guard._guarded() and _targets_cpu(a, kw):
                    guard._on_violation()
                return orig(t, *a, **kw)
        else:
            def pull(t, *a, **kw):
                if guard._guarded() and (t.is_cuda
                                         or not _in_plain_kernel()):
                    guard._on_violation()
                return orig(t, *a, **kw)
        pull.__name__ = name
        return pull

    def install(self) -> None:
        self._installs += 1
        if self._installs == 1:
            for name in _PULLS + _CUDA_PULLS:
                setattr(torch.Tensor, name, self._wrap(name))

    def uninstall(self) -> None:
        if self._installs == 0:
            return
        self._installs -= 1
        if self._installs == 0:
            for name in _PULLS + _CUDA_PULLS:
                delattr(torch.Tensor, name)

    @contextlib.contextmanager
    def window(self, name: str):
        self._bump(name, 1)
        try:
            yield
        finally:
            self._bump(name, -1)


def _cuda_mode() -> Optional[int]:
    """The current sync debug mode on a card, None without one."""
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_sync_debug_mode()


class Sentinel:
    """Guards the serving hot loop against host syncs and counts the
    input signatures of its entry points."""

    enabled = True

    def __init__(self, strict: bool = False):
        #: strict: raise on the first unsanctioned host pull instead of
        #: recording it (tests want the traceback; reports want totals)
        self.strict = strict
        self.violations: List[SyncViolation] = []
        self.sanctioned_pulls: Dict[str, int] = {}
        self.rebuilds: List[str] = []
        self.step: Optional[str] = None
        self.recaptures: Dict[str, int] = {}
        self._entries: Dict[str, Set[Any]] = {}
        self._warm: Optional[Dict[str, int]] = None
        self._armed = False
        self._phase = ""
        self._guard = _HostPullGuard(self._record_violation)

    # -- arming ----------------------------------------------------------
    def __enter__(self):
        self.arm()
        return self

    def __exit__(self, *exc):
        self.disarm()
        return False

    def arm(self) -> None:
        """Keep the patches installed until :meth:`disarm` (hot windows
        install them on their own too)."""
        if not self._armed:
            self._guard.install()
            self._armed = True

    def disarm(self) -> None:
        if self._armed:
            self._guard.uninstall()
            self._armed = False

    def _record_violation(self, where: Optional[str] = None,
                          kind: str = "host_sync") -> None:
        v = SyncViolation(where=where or _caller_site(), context=self._phase,
                          kind=kind)
        self.violations.append(v)
        if self.strict and kind == "host_sync":
            raise RuntimeError(
                f"unsanctioned device->host sync inside the serving hot "
                f"loop at {v.where} (phase {v.context or '?'}): wrap a "
                "legitimate pull site in sentinel.sanctioned(label)")

    def _on_warning(self, show):
        def hook(message, category, filename, lineno, *a, **kw):
            if _SYNC_MSG in str(message):
                # a sync inside a patched pull names the patch's frame
                site = _caller_site() if any(
                    p in filename.replace("\\", "/") for p in _SKIP) \
                    else f"{filename}:{lineno}"
                self._record_violation(site, "cuda_sync")
            else:
                show(message, category, filename, lineno, *a, **kw)
        return hook

    # -- transfer windows ------------------------------------------------
    @contextlib.contextmanager
    def hot(self, phase: str = "iter"):
        """The guarded window: one serving iteration.  On a card the sync
        debug mode is armed for its length ("error" when ``strict``, else
        "warn", each warning recorded)."""
        prev_phase, self._phase = self._phase, phase
        prev_mode = _cuda_mode()
        self._guard.install()
        try:
            with contextlib.ExitStack() as stack:
                if prev_mode is not None:
                    if not self.strict:
                        stack.enter_context(warnings.catch_warnings())
                        warnings.filterwarnings(
                            "always", message=f".*{_SYNC_MSG}.*")
                        warnings.showwarning = self._on_warning(
                            warnings.showwarning)
                    torch.cuda.set_sync_debug_mode(
                        "error" if self.strict else "warn")
                    stack.callback(torch.cuda.set_sync_debug_mode,
                                   prev_mode)
                with self._guard.window("hot"):
                    yield
        except RuntimeError as err:
            if _SYNC_MSG in str(err):
                tb = err.__traceback__
                site = "<unknown>"
                while tb is not None:
                    fn = tb.tb_frame.f_code.co_filename.replace("\\", "/")
                    if not any(p in fn for p in _SKIP):
                        site = (f"{fn}:{tb.tb_lineno} "
                                f"({tb.tb_frame.f_code.co_name})")
                    tb = tb.tb_next
                self._record_violation(site, "cuda_sync")
            raise
        finally:
            self._guard.uninstall()
            self._phase = prev_phase

    @contextlib.contextmanager
    def sanctioned(self, label: str):
        """A whitelisted pull site inside the hot window (sampling, the
        statistics read): the patches let it pass and the card's sync
        debug mode is off for its length."""
        self.sanctioned_pulls[label] = self.sanctioned_pulls.get(label, 0) + 1
        prev_mode = _cuda_mode()
        if prev_mode:
            torch.cuda.set_sync_debug_mode(0)
        try:
            with self._guard.window("sanctioned"):
                yield
        finally:
            if prev_mode:
                torch.cuda.set_sync_debug_mode(prev_mode)

    # -- input-signature accounting ----------------------------------------
    def register_entry(self, name: str, fn: Callable) -> Callable:
        """Track an entry point: returns ``fn`` wrapped so every call adds
        its input signature to the entry's set.  Re-registering a name (an
        engine rebuild) keeps the signatures already seen."""
        sigs = self._entries.setdefault(name, set())

        def counted(*args, **kwargs):
            sigs.add(_signature((args, kwargs)))
            return fn(*args, **kwargs)
        return counted

    def note_rebuild(self, reason: str) -> None:
        """A deliberate rebuild (e.g. the capacity-resize band)."""
        self.rebuilds.append(reason)

    def note_step(self, mode: str) -> None:
        """How the engine runs its chunk and decode forwards."""
        self.step = mode

    def note_capture(self, name: str, key: Any,
                     recapture: bool = False) -> None:
        """A CUDA graph of entry ``name`` captured for ``key``: a new key
        counts as a compile; ``recapture`` (the key's graph was dropped by
        a declared rebuild) is counted apart."""
        self._entries.setdefault(name, set()).add(key)
        if recapture:
            self.recaptures[name] = self.recaptures.get(name, 0) + 1

    def compile_counts(self) -> Dict[str, int]:
        """Distinct input signatures seen per entry."""
        return {n: len(self._entries[n]) for n in sorted(self._entries)}

    def mark_warm(self) -> Dict[str, int]:
        """End of warm-up: snapshot the per-entry counts.  Every new
        signature after this point is reported."""
        self._warm = self.compile_counts()
        return dict(self._warm)

    def post_warm_recompiles(self) -> Dict[str, int]:
        if self._warm is None:
            return {}
        now = self.compile_counts()
        return {n: now[n] - self._warm.get(n, 0) for n in now
                if now[n] - self._warm.get(n, 0) > 0}

    # -- report ----------------------------------------------------------
    @property
    def ok(self) -> bool:
        return not self.violations and not self.post_warm_recompiles()

    def report(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "violations": [dataclasses.asdict(v) for v in self.violations],
            "sanctioned_pulls": dict(sorted(self.sanctioned_pulls.items())),
            "compile_counts": self.compile_counts(),
            "warm_counts": dict(self._warm) if self._warm else None,
            "post_warm_recompiles": self.post_warm_recompiles(),
            "rebuilds": list(self.rebuilds),
            "step": self.step,
            "recaptures": dict(sorted(self.recaptures.items())),
        }


def _signature(tree) -> Any:
    """A hashable summary of a call's arguments: ``(shape, dtype, device)``
    of every tensor, the value of every hashable static leaf, and the type
    of anything else, in the arguments' structure."""
    if isinstance(tree, torch.Tensor):
        return ("T", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("D",) + tuple((k, _signature(tree[k]))
                              for k in sorted(tree, key=str))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_signature(v) for v in tree)
    try:
        hash(tree)
    except TypeError:
        return ("?", type(tree).__name__)
    return tree


class _NullSentinel:
    """Shared no-op: an engine without a sentinel pays nothing."""

    enabled = False
    strict = False
    violations: List[SyncViolation] = []
    rebuilds: List[str] = []

    _NULL_CTX = contextlib.nullcontext()

    def hot(self, phase: str = "iter"):
        return self._NULL_CTX

    def sanctioned(self, label: str):
        return self._NULL_CTX

    def register_entry(self, name: str, fn: Callable) -> Callable:
        return fn

    def note_rebuild(self, reason: str) -> None:
        pass

    def note_step(self, mode: str) -> None:
        pass

    def note_capture(self, name: str, key: Any,
                     recapture: bool = False) -> None:
        pass

    def mark_warm(self) -> Dict[str, int]:
        return {}

    def post_warm_recompiles(self) -> Dict[str, int]:
        return {}

    def compile_counts(self) -> Dict[str, int]:
        return {}

    @property
    def ok(self) -> bool:
        return True

    def report(self) -> Dict[str, Any]:
        return {"ok": True, "violations": [], "sanctioned_pulls": {},
                "compile_counts": {}, "warm_counts": None,
                "post_warm_recompiles": {}, "rebuilds": [], "step": None,
                "recaptures": {}}


NULL_SENTINEL = _NullSentinel()

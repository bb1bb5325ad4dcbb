"""The work of each kernel of the port, and the hook through which its
entry reports it.

One source of the kernels' costs: the op-level analyzer of the dry run
(``repro_torch.launch.op_analysis``) adds a kernel's :class:`Work` at its
entry in ``kernels.ops`` whatever implements it there (the CUDA kernel,
the plain version on the CPU, the shape function on ``meta``), without
counting the operations of the plain version a second time; and
``chip_smoke.py`` prices its kernels' least times from the same formulas.

A formula takes the rows that work and the slots that hold them as
arguments.  The analyzer passes every row and every slot the kernel is
given (its shapes' work, which does not depend on the data and so is the
same on every device); ``chip_smoke.py`` passes the rows and slots that
this run's data makes work (its bounds).

With no analyzer active, :func:`run` calls the entry and nothing more,
and :func:`alternatives` and :func:`branch` enter nothing.
"""
from __future__ import annotations

import contextlib

from typing import Callable, Dict, NamedTuple, Optional

# bytes of one NVFP4 weight: a 4-bit code and its share of the f32 scale
# of its group of 16
FP4_WEIGHT_BYTES = 0.5 + 4 / 16


class Work(NamedTuple):
    """One launch's work: tensor-core FLOPs (two a multiply-add), the bytes
    it must read and write once each, and the bytes of scratch its CUDA
    wrapper allocates beside its outputs (live only during the launch)."""
    flops: float
    read: int
    written: int
    temp: int = 0

    @property
    def nbytes(self) -> int:
        return self.read + self.written


def global_scale(n: int, itemsize: int) -> Work:
    """The amax of ``n`` weights into one f32 scale: the weights read."""
    return Work(0.0, n * itemsize, 4)


def quantizer(n: int, itemsize: int) -> Work:
    """``n`` weights to packed codes (n/2 bytes) and f32 group scales
    (n/16 of them), with the f32 global scale read."""
    return Work(0.0, n * itemsize + 4, n // 2 + (n // 16) * 4)


def grouped_ffn(m: int, d: int, f: int, itemsize: int, n_counts: int,
                rows: int, n_live: int, fp4: bool,
                w_itemsize: Optional[int] = None) -> Work:
    """One grouped SwiGLU FFN launch over ``m`` rows of ``d`` with ``f``
    hidden, ``n_counts`` slot counts: ``rows`` rows work (6·d·f FLOPs
    each) and ``n_live`` slots' weights are read (FP4: 4.25 bits a weight
    and three global scales; plain: ``w_itemsize``, default ``itemsize``).
    The rows are read and the output written once.  Scratch: the FP4
    design's quantized rows ``xq [m, d]``, both designs' hidden rows
    ``[m, f]`` and, in f32, their zero-row flags ``[m]`` int32."""
    w_bytes = FP4_WEIGHT_BYTES if fp4 else (w_itemsize or itemsize)
    read = (int(n_live * 3 * f * d * w_bytes) + m * d * itemsize
            + n_counts * 4 + (12 if fp4 else 0))
    temp = (m * d * itemsize if fp4 else 0) + m * f * itemsize \
        + (m * 4 if itemsize == 4 else 0)
    return Work(6.0 * rows * d * f, read, m * d * itemsize, temp)


def grouped_ffn_bwd(m: int, d: int, f: int, itemsize: int, n_counts: int,
                    n_w: int, rows: int, n_live: int) -> Work:
    """One backward launch: eight products of 2·d·f a working row (g, u and
    dh recomputed, dx twice, three weight gradients); xs and dy read, dxs
    written, the weights of the ``n_live`` slots with rows read, the three
    gradients of all ``n_w`` slots written.  Scratch: ``dg``, ``du`` and
    ``h [m, f]``."""
    read = 2 * m * d * itemsize + n_counts * 4 + 3 * d * f * itemsize * n_live
    written = m * d * itemsize + 3 * d * f * itemsize * n_w
    return Work(16.0 * rows * d * f, read, written, 3 * m * f * itemsize)


def fp4_matmul(m: int, n: int, k: int, x_itemsize: int,
               out_itemsize: int) -> Work:
    """``x [m, k] @ Wᵀ`` with NVFP4 ``W [n, k]``: 2·m·n·k FLOPs; x, the
    codes, the group scales and the global scale read, ``y`` written."""
    read = m * k * x_itemsize + n * k // 2 + (n * k // 16) * 4 + 4
    return Work(2.0 * m * n * k, read, m * n * out_itemsize)


# --------------------------------------------------------------------------
# the hook
# --------------------------------------------------------------------------
# the active analyzer (launch.op_analysis.OpAnalyzer, or the audit), or
# None: module-wide, not thread-local, since a step's backward launches its
# kernels on autograd's device thread
_analyzer = None


def set_analyzer(analyzer):
    """Make ``analyzer`` the active one (None: none); returns the one it
    replaces."""
    global _analyzer
    prev, _analyzer = _analyzer, analyzer
    return prev


def run(works: Callable[[], Dict[str, Work]], fn: Callable, *args, **kw):
    """``fn(*args, **kw)``, a kernel entry's body.  With an analyzer
    active, the operations it dispatches are not counted; ``works()``
    (each launch's :class:`Work` by kernel name) is, and its outputs are
    counted live from then on."""
    an = _analyzer
    if an is None:
        return fn(*args, **kw)
    return an.kernel(works, fn, args, kw)


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


@contextlib.contextmanager
def uncounted():
    """The ops that move a collective (a staged backend's host copies,
    the process group's own): the analyzer counts a collective by the
    mesh's census, not by them, so a step's counts on a mesh of ranks
    equal those on the abstract mesh, where nothing moves."""
    an = _analyzer
    if an is None or not hasattr(an, "_paused"):
        yield
        return
    an._paused += 1
    try:
        yield
    finally:
        an._paused -= 1


def alternatives():
    """A scope whose :func:`branch` scopes are alternatives behind a device
    predicate (one MoE layer's BF16 and FP4 paths): the analyzer prices
    the larger of them, never their sum, as the reference's HLO analysis
    prices a ``conditional``'s branches."""
    return _NULL if _analyzer is None else _analyzer.alternatives()


def branch(name: str):
    """The work inside is branch ``name`` of the enclosing
    :func:`alternatives` (outside one, it counts as it comes)."""
    return _NULL if _analyzer is None else _analyzer.branch(name)

"""NVFP4 weight quantizer: the CUDA kernels, their plain versions, their
counters.

Counterpart of ``repro.kernels.quantize_fp4`` (the Pallas
``quantize_fp4_kernel``) and of the global scale the reference computes
before it (``global_scale_for``, an XLA reduction).  ``w [G, N, K]`` (any
strides) with a global scale ``gs`` → ``packed u8 [G, N, K/2]``, ``scales f32
[G, N, K/16]``; the kernel source is ``csrc/quantize_fp4.cu``.
``quantize_fp4_cuda`` is bitwise equal to ``quantize_fp4_plain`` and
``global_scale_cuda`` to ``global_scale_plain``.

Both take an optional device predicate ``pred`` (ReaLB's FP4 decision, a
0-dim tensor): with ``pred`` 0 the kernels return at once and write
nothing, and the host never reads ``pred``.  The plain versions, which run
on the CPU only, branch on it there (free on the CPU) and return zeros.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build, working

launches = 0        # kernel launches made by quantize_fp4_cuda
scale_launches = 0  # kernel launches made by global_scale_cuda

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
             + [ctypes.c_void_p] * 2)
_SCALE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6
                   + [ctypes.c_void_p])
_ENTRY = {torch.bfloat16: "quantize_fp4_bf16", torch.float32: "quantize_fp4_f32"}
_SCALE_ENTRY = {torch.bfloat16: "global_scale_fp4_bf16",
                torch.float32: "global_scale_fp4_f32"}
# the global-scale kernel's two-word scratch, one per device: zeroed once,
# left zeroed by every launch; the launches that share it run in order on
# the current stream
_scale_scratch: Dict[torch.device, torch.Tensor] = {}


def scale_scratch(device: torch.device) -> torch.Tensor:
    """The global-scale kernel's scratch on ``device``, made and zeroed at
    its first use.  A CUDA-graph capture must find it made: inside one the
    zero fill would be recorded, not run, and the memory would come from
    the graph's pool."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    buf = _scale_scratch.get(device)
    if buf is None:
        buf = torch.zeros((2,), dtype=torch.int32, device=device)
        _scale_scratch[device] = buf
    return buf


def _off(pred: Optional[torch.Tensor]) -> bool:
    """The plain versions' branch on a CPU predicate."""
    return pred is not None and not bool(pred)


def quantize_fp4_plain(w: torch.Tensor, gs: torch.Tensor,
                       group: int = quant.GROUP,
                       pred: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (the quant.quantize_fp4 recipe
    with the given global scale); zeros when ``pred`` is 0."""
    if _off(pred):
        *lead, k = w.shape
        return (torch.zeros((*lead, k // 2), dtype=torch.uint8,
                            device=w.device),
                torch.zeros((*lead, k // group), dtype=torch.float32,
                            device=w.device))
    q = quant.quantize_fp4(w, group, global_scale=gs)
    return q.packed, q.scales


def global_scale_plain(w: torch.Tensor,
                       pred: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``quant.global_scale_for(w)``; zero when ``pred`` is 0."""
    if _off(pred):
        return torch.zeros((), dtype=torch.float32, device=w.device)
    return quant.global_scale_for(w)


def dense(w: torch.Tensor) -> bool:
    """True when ``w`` is a permutation of one contiguous block: its
    strides, sorted, are 1, s0, s0·s1 (size-1 dimensions aside).  The
    global-scale kernel reads such a view flat."""
    expect = 1
    for stride, size in sorted(zip(w.stride(), w.shape)):
        if size == 1:
            continue
        if stride != expect:
            return False
        expect *= size
    return True


def _check(w: torch.Tensor, what: str, pred: Optional[torch.Tensor],
           shape_ok: bool, want: str) -> None:
    if w.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors")
    if pred is not None and pred.device != w.device:
        raise ValueError(f"{what}: pred must lie on the device of w")
    if w.dtype not in _ENTRY:
        raise TypeError(f"{what}: unsupported dtype {w.dtype}")
    if not shape_ok:
        raise ValueError(f"{what}: want {want}, got {tuple(w.shape)}")


def _pred_ptr(pred: Optional[torch.Tensor]):
    """(int32[1] tensor kept alive by the caller, its pointer or None)."""
    if pred is None:
        return None, None
    p32 = pred.to(torch.int32).reshape(1).contiguous()
    return p32, p32.data_ptr()


def quantize_fp4_meta(w: torch.Tensor, gs: torch.Tensor,
                      pred: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's shape function on ``meta`` tensors: the outputs
    :func:`quantize_fp4_cuda` allocates, unwritten."""
    *lead, k = w.shape
    return (torch.empty((*lead, k // 2), dtype=torch.uint8, device=w.device),
            torch.empty((*lead, k // quant.GROUP), dtype=torch.float32,
                        device=w.device))


def global_scale_meta(w: torch.Tensor,
                      pred: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The global-scale kernel's shape function on ``meta`` tensors."""
    return torch.empty((1,), dtype=torch.float32,
                       device=w.device).reshape(())


def quantize_fp4_cuda(w: torch.Tensor, gs: torch.Tensor,
                      pred: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on ``w [G, N, K]`` (CUDA, bf16 or f32, any strides;
    K a multiple of 32) with the f32 scalar ``gs`` on the same device."""
    global launches
    _check(w, "quantize_fp4_cuda", pred,
           w.dim() == 3 and w.shape[-1] % 32 == 0,
           "[G, N, K] with K % 32 == 0")
    if gs.device != w.device:
        raise ValueError("quantize_fp4_cuda: gs must lie on the device of w")
    g, n, k = w.shape
    gs32 = gs.to(torch.float32).reshape(1).contiguous()
    packed = torch.empty((g, n, k // 2), dtype=torch.uint8, device=w.device)
    scales = torch.empty((g, n, k // quant.GROUP), dtype=torch.float32,
                         device=w.device)
    p32, p_ptr = _pred_ptr(pred)
    fn = _build.entry("quantize_fp4", _ENTRY[w.dtype], _ARGTYPES)
    sg, sn, sk = w.stride()
    err = fn(w.data_ptr(), gs32.data_ptr(), packed.data_ptr(),
             scales.data_ptr(), g, n, k, sg, sn, sk, p_ptr,
             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "quantize_fp4")
    launches += 1
    working.note("quantize_fp4", lambda: 1 if p32 is None else p32)
    return packed, scales


def global_scale_cuda(w: torch.Tensor,
                      pred: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the global-scale kernel on ``w [G, N, K]`` (CUDA, bf16 or
    f32; any shape when ``dense(w)``, else K a multiple of 16); returns the
    f32 scalar on the device (unwritten when ``pred`` is 0)."""
    global scale_launches
    _check(w, "global_scale_cuda", pred,
           w.dim() == 3 and (w.shape[-1] % 16 == 0 or dense(w)),
           "[G, N, K], dense or with K % 16 == 0")
    g, n, k = w.shape
    amax_bits = scale_scratch(w.device)
    gscale = torch.empty((1,), dtype=torch.float32, device=w.device)
    p32, p_ptr = _pred_ptr(pred)
    fn = _build.entry("quantize_fp4", _SCALE_ENTRY[w.dtype],
                      _SCALE_ARGTYPES)
    sg, sn, sk = w.stride()
    err = fn(w.data_ptr(), p_ptr, amax_bits.data_ptr(), gscale.data_ptr(),
             g, n, k, sg, sn, sk,
             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "global_scale_fp4")
    scale_launches += 1
    working.note("global_scale_fp4", lambda: 1 if p32 is None else p32)
    return gscale.reshape(())

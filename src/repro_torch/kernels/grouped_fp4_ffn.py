"""Grouped W4A4 SwiGLU expert FFN: the CUDA kernel, its plain version, its
counter.

Counterpart of ``repro.kernels.grouped_fp4_ffn`` (the Pallas
``grouped_fp4_ffn_kernel``).  Over slot-sorted rows ``xs [M, D]`` with
per-slot counts ``gs [G]``: ``xq = a4(x)``; ``gate, up = xq·deq(W)ᵀ``;
``h = silu(gate)·up``; ``y = a4(h)·deq(Wd)ᵀ``, with gate/up quantized along D
(``[G, F, D/2]`` + ``[G, F, D/16]``), down along F (``[G, D, F/2]`` +
``[G, D, F/16]``) and three global scales.  The kernel source is
``csrc/grouped_fp4_ffn.cu``; ``grouped_fp4_ffn_plain`` is the reference's
jnp oracle (dequantize, then one product per slot).
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels import _build
from repro_torch.kernels.nvfp4 import fake_quant_a4

launches = 0        # kernel launches made by grouped_fp4_ffn_cuda

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
             + [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 3
             + [ctypes.c_void_p])
_ENTRY = {torch.bfloat16: "grouped_fp4_ffn_bf16",
          torch.float32: "grouped_fp4_ffn_f32"}


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, gs: torch.Tensor
                   ) -> torch.Tensor:
    """Ragged product: rows of group g (``gs[g]`` consecutive rows) times
    ``w[g] [K, N]``, f32 accumulate, cast to x's dtype; rows past
    ``sum(gs)`` are 0 (``jax.lax.ragged_dot`` semantics)."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    r0 = 0
    for g, c in enumerate(gs.tolist()):        # one host sync per call
        if c:
            out[r0:r0 + c] = torch.matmul(x[r0:r0 + c], w[g])
        r0 += c
    return out


def grouped_fp4_ffn_plain(xs, gs, gate_packed, gate_scales, up_packed,
                          up_scales, down_packed, down_scales, global_scales,
                          group: int = quant.GROUP,
                          act: Callable = F.silu) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    dtype = xs.dtype

    def dq_t(packed, scales, gsc):     # [G, N, K] codes -> [G, K, N] dtype
        w = quant.dequantize_fp4(quant.QTensor(packed, scales, gsc))
        return w.transpose(-1, -2).to(dtype)

    xq = fake_quant_a4(xs, group).to(dtype)
    g = grouped_matmul(xq, dq_t(gate_packed, gate_scales, global_scales[0]),
                       gs)
    u = grouped_matmul(xq, dq_t(up_packed, up_scales, global_scales[1]), gs)
    h = act(g.to(torch.float32)).to(dtype) * u
    hq = fake_quant_a4(h, group).to(dtype)
    return grouped_matmul(hq, dq_t(down_packed, down_scales,
                                   global_scales[2]), gs)


def grouped_fp4_ffn_cuda(xs, gs, gate_packed, gate_scales, up_packed,
                         up_scales, down_packed, down_scales, global_scales
                         ) -> torch.Tensor:
    """Launch the kernel (SwiGLU, group 16) on CUDA tensors; ``xs`` bf16 or
    f32 with D and F multiples of 32."""
    global launches
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError("grouped_fp4_ffn_cuda takes CUDA tensors")
    if xs.dtype not in _ENTRY:
        raise TypeError(f"grouped_fp4_ffn_cuda: unsupported dtype {xs.dtype}")
    m, d = xs.shape
    n_g, f, d2 = gate_packed.shape
    if d % 32 or f % 32 or d2 * 2 != d or gs.shape != (n_g,) \
            or down_packed.shape != (n_g, d, f // 2):
        raise ValueError(f"grouped_fp4_ffn_cuda: bad shapes xs {tuple(xs.shape)}"
                         f" gs {tuple(gs.shape)} gate {tuple(gate_packed.shape)}"
                         f" down {tuple(down_packed.shape)}")
    args = [xs, gs.to(torch.int32), gate_packed, gate_scales.float(),
            up_packed, up_scales.float(), down_packed, down_scales.float(),
            global_scales.to(torch.float32).reshape(3)]
    args = [a.contiguous() for a in args]
    for a in args:
        if a.device != dev or a.data_ptr() % 16:
            raise ValueError("grouped_fp4_ffn_cuda: every input must be a "
                             "16-byte aligned tensor on the device of xs")
    xq = torch.empty((m, d), dtype=xs.dtype, device=dev)
    nz = torch.empty((m,), dtype=torch.int32, device=dev)
    hq = torch.empty((m, f), dtype=xs.dtype, device=dev)
    out = torch.zeros((m, d), dtype=xs.dtype, device=dev)
    fn = getattr(_build.load()["grouped_fp4_ffn"], _ENTRY[xs.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    x, g32, gp, gsc, up, usc, dp, dsc, gscales = args
    err = fn(x.data_ptr(), g32.data_ptr(), n_g, gp.data_ptr(), gsc.data_ptr(),
             up.data_ptr(), usc.data_ptr(), dp.data_ptr(), dsc.data_ptr(),
             gscales.data_ptr(), xq.data_ptr(), nz.data_ptr(), hq.data_ptr(),
             out.data_ptr(), m, d, f,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "grouped_fp4_ffn")
    launches += 1
    return out

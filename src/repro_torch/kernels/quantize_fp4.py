"""NVFP4 weight quantizer: the CUDA kernel, its plain version, its counter.

Counterpart of ``repro.kernels.quantize_fp4`` (the Pallas
``quantize_fp4_kernel``).  ``w [G, N, K]`` (any strides) with a global
scale ``gs`` → ``packed u8 [G, N, K/2]``, ``scales f32 [G, N, K/16]``;
the kernel source is ``csrc/quantize_fp4.cu``.  ``quantize_fp4_cuda`` is
bitwise equal to ``quantize_fp4_plain``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build

launches = 0        # kernel launches made by quantize_fp4_cuda

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
_ENTRY = {torch.bfloat16: "quantize_fp4_bf16", torch.float32: "quantize_fp4_f32"}


def quantize_fp4_plain(w: torch.Tensor, gs: torch.Tensor,
                       group: int = quant.GROUP
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch (the quant.quantize_fp4 recipe
    with the given global scale)."""
    q = quant.quantize_fp4(w, group, global_scale=gs)
    return q.packed, q.scales


def quantize_fp4_cuda(w: torch.Tensor, gs: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on ``w [G, N, K]`` (CUDA, bf16 or f32, any strides;
    K a multiple of 32) with the f32 scalar ``gs`` on the same device."""
    global launches
    if w.device.type != "cuda" or gs.device != w.device:
        raise ValueError("quantize_fp4_cuda takes CUDA tensors on one device")
    if w.dtype not in _ENTRY:
        raise TypeError(f"quantize_fp4_cuda: unsupported dtype {w.dtype}")
    if w.dim() != 3 or w.shape[-1] % 32:
        raise ValueError(f"quantize_fp4_cuda: want [G, N, K] with K % 32 == "
                         f"0, got {tuple(w.shape)}")
    g, n, k = w.shape
    gs32 = gs.to(torch.float32).reshape(1).contiguous()
    packed = torch.empty((g, n, k // 2), dtype=torch.uint8, device=w.device)
    scales = torch.empty((g, n, k // quant.GROUP), dtype=torch.float32,
                         device=w.device)
    fn = getattr(_build.load()["quantize_fp4"], _ENTRY[w.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    sg, sn, sk = w.stride()
    err = fn(w.data_ptr(), gs32.data_ptr(), packed.data_ptr(),
             scales.data_ptr(), g, n, k, sg, sn, sk,
             torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(err, "quantize_fp4")
    launches += 1
    return packed, scales

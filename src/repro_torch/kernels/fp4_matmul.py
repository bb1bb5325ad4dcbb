"""W4(A4) GEMM with NVFP4 weights: the CUDA kernel, its plain version, its
counter.

Counterpart of ``repro.kernels.fp4_matmul`` (the Pallas
``fp4_matmul_kernel``).  ``y [M, N] = a4?(x) [M, K] · deq(packed [N, K/2],
scales [N, K/16], gs)ᵀ`` with f32 accumulation; the kernel source is
``csrc/fp4_matmul.cu``.  Both versions dequantize in the Pallas kernel's
order, ``level·(scale·gs)``, not the jnp oracle's ``(level·scale)·gs``
(``repro_torch.kernels.ref``), so they agree with the oracle to rounding,
as the Pallas kernel does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quant
from repro_torch.kernels import _build
from repro_torch.kernels.nvfp4 import decode_level, fake_quant_a4

launches = 0        # kernel launches made by fp4_matmul_cuda

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3
             + [ctypes.c_int, ctypes.c_void_p])
_TYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def dequantize_kernel_order(packed: torch.Tensor, scales: torch.Tensor,
                            gs: torch.Tensor) -> torch.Tensor:
    """``packed [N, K/2]`` → f32 ``[N, K]`` as ``level·(scale·gs)``."""
    vals = decode_level(quant.unpack_u4(packed))               # [N, K]
    n, k = vals.shape
    g = k // scales.shape[-1]
    sg = scales.to(torch.float32) * gs.to(torch.float32)
    return (vals.reshape(n, k // g, g) * sg[..., None]).reshape(n, k)


def fp4_matmul_plain(x: torch.Tensor, packed: torch.Tensor,
                     scales: torch.Tensor, gs: torch.Tensor, *,
                     a4: bool = False, group: int = quant.GROUP,
                     out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    xf = x.to(torch.float32)
    if a4:
        xf = fake_quant_a4(xf, group)
    w = dequantize_kernel_order(packed, scales, gs)
    return torch.matmul(xf, w.t()).to(out_dtype)


def fp4_matmul_meta(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, gs: torch.Tensor, *,
                    a4: bool = False, out_dtype=torch.float32
                    ) -> torch.Tensor:
    """The kernel's shape function on ``meta`` tensors: the output
    :func:`fp4_matmul_cuda` allocates."""
    return torch.empty((x.shape[0], packed.shape[0]), dtype=out_dtype,
                       device=x.device)


def fp4_matmul_cuda(x: torch.Tensor, packed: torch.Tensor,
                    scales: torch.Tensor, gs: torch.Tensor, *,
                    a4: bool = False, out_dtype=torch.float32
                    ) -> torch.Tensor:
    """Launch the kernel (group 16) on CUDA tensors: ``x [M, K]`` bf16 or
    f32 with K a multiple of 32, ``gs`` an f32 scalar on the device; ``y``
    f32 or bf16."""
    global launches
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("fp4_matmul_cuda takes CUDA tensors")
    if x.dtype not in _TYPES or out_dtype not in _TYPES:
        raise TypeError(f"fp4_matmul_cuda: unsupported dtypes {x.dtype} -> "
                        f"{out_dtype}")
    m, k = x.shape
    n = packed.shape[0]
    if k % 32 or packed.shape != (n, k // 2) \
            or scales.shape != (n, k // quant.GROUP):
        raise ValueError(f"fp4_matmul_cuda: bad shapes x {tuple(x.shape)} "
                         f"packed {tuple(packed.shape)} scales "
                         f"{tuple(scales.shape)}")
    args = [x.contiguous(), packed.contiguous(),
            scales.to(torch.float32).contiguous(),
            gs.to(torch.float32).reshape(1).contiguous()]
    for a in args:
        if a.device != dev or a.data_ptr() % 16:
            raise ValueError("fp4_matmul_cuda: every input must be a 16-byte "
                             "aligned tensor on the device of x")
    xc, pc, sc, g1 = args
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    name = f"fp4_matmul_{_TYPES[x.dtype]}_{_TYPES[out_dtype]}"
    fn = _build.entry("fp4_matmul", name, _ARGTYPES)
    err = fn(xc.data_ptr(), pc.data_ptr(), sc.data_ptr(), g1.data_ptr(),
             y.data_ptr(), m, n, k, int(a4),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fp4_matmul")
    launches += 1
    return y

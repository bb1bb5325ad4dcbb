"""NVFP4 quantization recipe (paper Appendix E) in plain PyTorch.

The counterpart of ``repro.core.quant``: weights in FP4 E2M1, symmetric
min-max per group of 16 along the contraction dim, local scale = amax/6
stored E4M3-valued in f32, one global f32 scale per tensor.  Bitwise equal
to the jitted reference; the plain version of the quantize kernel
(``repro_torch.kernels.quantize_fp4``) is this recipe.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import nvfp4

FP4_MAX = nvfp4.FP4_MAX
INV_FP4_MAX = nvfp4.INV_FP4_MAX
E4M3_MAX = nvfp4.E4M3_MAX
GROUP = nvfp4.GROUP
# XLA compiles the reference's ``amax / (FP4_MAX * E4M3_MAX)`` into a
# multiplication by this f32 reciprocal; true division differs bitwise
INV_FP4_E4M3 = float(np.float32(1.0) / np.float32(FP4_MAX * E4M3_MAX))

fp4_decode = nvfp4.decode_level


def pack_u4(codes: torch.Tensor) -> torch.Tensor:
    """Pack uint8 4-bit codes pairwise along the last dim -> uint8 [..., K/2]."""
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_u4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_u4` -> uint8 [..., K]."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                 packed.shape[-1] * 2)


class QTensor(NamedTuple):
    """Group-quantized NVFP4 tensor (packed along the last axis)."""

    packed: torch.Tensor        # uint8 [..., K/2]
    scales: torch.Tensor        # f32 (e4m3-valued) [..., K/GROUP]
    global_scale: torch.Tensor  # f32 scalar

    @property
    def k(self) -> int:
        return self.packed.shape[-1] * 2


def global_scale_for(w: torch.Tensor) -> torch.Tensor:
    """Per-tensor scale aligning group amaxes into E4M3 range (f32 scalar)."""
    amax = w.abs().amax().to(torch.float32)   # |w| and max are exact in w's dtype
    return torch.clamp(amax * INV_FP4_E4M3, min=1e-20)


def quantize_fp4(w: torch.Tensor, group: int = GROUP,
                 global_scale: Optional[torch.Tensor] = None) -> QTensor:
    """NVFP4 group quantization along the last axis (must divide by group)."""
    *lead, k = w.shape
    if k % group:
        raise ValueError(f"last dim {k} is not a multiple of {group}")
    wf = w.to(torch.float32).reshape(*lead, k // group, group)
    amax = wf.abs().amax(dim=-1)                              # [..., K/g]
    gscale = global_scale_for(w) if global_scale is None \
        else torch.as_tensor(global_scale, dtype=torch.float32,
                             device=w.device)
    s_local = nvfp4.e4m3_round(amax * INV_FP4_MAX / gscale)
    s_local = torch.clamp(s_local, min=2.0 ** -9)             # avoid /0
    codes = nvfp4.fp4_code(wf / (s_local * gscale)[..., None])
    packed = pack_u4(codes.reshape(*lead, k))
    return QTensor(packed, s_local, gscale)


def dequantize_fp4(q: QTensor, dtype=torch.float32) -> torch.Tensor:
    vals = fp4_decode(unpack_u4(q.packed))                    # [..., K]
    *lead, k = vals.shape
    g = k // q.scales.shape[-1]
    vals = vals.reshape(*lead, k // g, g) * q.scales[..., None] \
        * q.global_scale
    return vals.reshape(*lead, k).to(dtype)


def fp4_sim(x: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """Fake-quantize (quantize+dequantize) along the last axis, same dtype.

    Straight-through: the gradient is the identity (the reference's
    ``jax.lax.stop_gradient`` around the rounding)."""
    q = quantize_fp4(x.detach(), group)
    dq = dequantize_fp4(q, torch.float32)
    xf = x.to(torch.float32)
    return (xf + (dq - xf).detach()).to(x.dtype)


def quant_error(w: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """Relative Frobenius error of the NVFP4 round-trip (accuracy proxy)."""
    wf = w.to(torch.float32)
    dq = dequantize_fp4(quantize_fp4(wf, group))
    return torch.linalg.norm(dq - wf) / torch.clamp(torch.linalg.norm(wf),
                                                    min=1e-20)


# --------------------------------------------------------------------------
# quantized matmul references (the numerics the kernels must match)
# --------------------------------------------------------------------------
def matmul_w4a16(x: torch.Tensor, qw: QTensor) -> torch.Tensor:
    """x [M,K] @ dequant(qw) [K,N] with qw quantized along K (stored [N,K])."""
    w = dequantize_fp4(qw, torch.float32)                     # [N,K]
    return (x.to(torch.float32) @ w.t()).to(x.dtype)


def matmul_w4a4(x: torch.Tensor, qw: QTensor,
                group: int = GROUP) -> torch.Tensor:
    """NVFP4 W4A4 GEMM simulation: both operands fake-quantized per group-K."""
    xq = fp4_sim(x.to(torch.float32), group)
    w = dequantize_fp4(qw, torch.float32)
    return (xq @ w.t()).to(x.dtype)

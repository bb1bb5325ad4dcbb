"""Plain oracles of the kernels (bit-exact NVFP4 numerics).

Counterpart of ``repro.kernels.ref``: they delegate to
:mod:`repro_torch.core.quant`, the paper's quantization recipe, so the
kernels' plain versions and the accuracy checks share one numerical ground
truth.  ``fp4_matmul_ref`` dequantizes in the recipe's order
``(level·scale)·gs``; the kernel's plain version
(``kernels.fp4_matmul.fp4_matmul_plain``) mirrors the kernel's order
``level·(scale·gs)`` and agrees with it to rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels import nvfp4


def quantize_fp4_ref(w: torch.Tensor, global_scale: torch.Tensor,
                     group: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [N,K] -> (packed u8 [N,K/2], scales f32 [N,K/group])."""
    q = quant.quantize_fp4(w, group, global_scale=global_scale)
    return q.packed, q.scales


def fp4_matmul_ref(x: torch.Tensor, packed: torch.Tensor,
                   scales: torch.Tensor, global_scale: torch.Tensor,
                   group: int = 16, a4: bool = False,
                   out_dtype=torch.float32) -> torch.Tensor:
    """x [M,K] @ dequant(packed [N,K/2], scales [N,K/g])^T -> [M,N]."""
    q = quant.QTensor(packed, scales,
                      torch.as_tensor(global_scale, dtype=torch.float32))
    w = quant.dequantize_fp4(q, torch.float32)                # [N,K]
    xf = x.to(torch.float32)
    if a4:
        # dynamic per-group activation fake-quant (amax/6 scale, E2M1 grid)
        m, k = xf.shape
        xg = xf.reshape(m, k // group, group)
        amax = torch.amax(xg.abs(), dim=-1, keepdim=True)
        gs = torch.clamp(amax / quant.FP4_MAX, min=1e-20)
        xf = (nvfp4.fp4_round(xg / gs) * gs).reshape(m, k)
    return (xf @ w.t()).to(out_dtype)


def dequantize_ref(packed, scales, global_scale, dtype=torch.float32):
    q = quant.QTensor(packed, scales,
                      torch.as_tensor(global_scale, dtype=torch.float32))
    return quant.dequantize_fp4(q, dtype)

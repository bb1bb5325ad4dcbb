"""NVFP4 (E2M1 + E4M3 group scales) numerics in plain PyTorch.

The counterpart of ``repro.kernels.nvfp4``: every plain version of an FP4
kernel in the port, and ``repro_torch.core.quant``, build on these helpers,
and the CUDA kernels in ``repro_torch/csrc`` repeat the same arithmetic
element for element.  Results are bitwise equal to the jitted reference,
which constrains two spellings:

* a division by a constant is written as a multiplication by the f32
  reciprocal (``amax * INV_FP4_MAX``), because XLA compiles the
  reference's ``amax / FP4_MAX`` into exactly that;
* ``torch.round`` rounds half to even, as ``jnp.round`` does.

Format recap (paper Appendix E): values quantize to E2M1
``{0, ±0.5, ±1, ±1.5, ±2, ±3, ±4, ±6}``; symmetric min-max per group of 16
along the contraction dim with local scale ``amax/6`` rounded to FP8 E4M3;
one global f32 scale per tensor keeps local scales inside E4M3 range.
"""
from __future__ import annotations

import numpy as np
import torch

GROUP = 16
FP4_MAX = 6.0
INV_FP4_MAX = float(np.float32(1.0) / np.float32(6.0))
E4M3_MAX = 448.0
# round-to-nearest decision boundaries between consecutive E2M1 levels
FP4_MIDPOINTS = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)


def fp4_index(mag: torch.Tensor) -> torch.Tensor:
    """Level index in [0,7] for a non-negative magnitude (int32)."""
    idx = torch.zeros(mag.shape, dtype=torch.int32, device=mag.device)
    for mid in FP4_MIDPOINTS:
        idx = idx + (mag > mid).to(torch.int32)
    return idx


def fp4_level(idx: torch.Tensor) -> torch.Tensor:
    """E2M1 magnitude for a level index (compare-select, exact in f32)."""
    idxf = idx.to(torch.float32)
    hi = torch.where(idxf == 7.0, 6.0, idxf - 2.0)
    return torch.where(idxf < 4.0, 0.5 * idxf, hi)


def fp4_round(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest E2M1-representable value. Any shape, f32 math."""
    xf = x.to(torch.float32)
    return torch.sign(xf) * fp4_level(fp4_index(xf.abs()))


def fp4_code(x: torch.Tensor) -> torch.Tensor:
    """4-bit code: bit3 = sign, bits0..2 = level index. uint8 in [0,15]."""
    xf = x.to(torch.float32)
    idx = fp4_index(xf.abs())
    sign = (xf < 0).to(torch.int32)
    return (sign * 8 + idx).to(torch.uint8)


def decode_level(code: torch.Tensor) -> torch.Tensor:
    """Signed E2M1 value from a 4-bit code (f32)."""
    idx = (code & 7).to(torch.int32)
    sign = 1.0 - 2.0 * ((code >> 3) & 1).to(torch.float32)
    return sign * fp4_level(idx)


def e4m3_round(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even onto FP8 E4M3 (±448, denormals at 2^-9)."""
    xf = x.to(torch.float32)
    mag = torch.clamp(xf.abs(), 0.0, E4M3_MAX)
    # exponent of the representation bucket; denormal floor at 2^-6
    e = torch.floor(torch.log2(torch.clamp(mag, min=1e-38)))
    e = torch.clamp(e, -6.0, 8.0)
    ulp = torch.exp2(e - 3.0)                  # 3 mantissa bits
    q = torch.round(mag / ulp) * ulp
    # rounding up may bump the exponent (e.g. 1.9375 -> 2.0): representable.
    q = torch.where(mag == 0.0, 0.0, torch.clamp(q, max=E4M3_MAX))
    return torch.sign(xf) * q


def fake_quant_a4(x: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """Activation NVFP4 fake-quant with *dynamic* per-group scales.

    Groups of ``group`` along the last axis; local scale = amax/6 kept in
    exact f32.  Returns f32; callers cast as needed.
    """
    xf = x.to(torch.float32)
    shape = xf.shape
    xg = xf.reshape(*shape[:-1], shape[-1] // group, group)
    amax = xg.abs().amax(dim=-1, keepdim=True)
    gs = torch.clamp(amax * INV_FP4_MAX, min=1e-20)   # dynamic per-group scale
    r = xg / gs
    q = torch.sign(r) * fp4_level(fp4_index(r.abs())) * gs
    return q.reshape(shape)

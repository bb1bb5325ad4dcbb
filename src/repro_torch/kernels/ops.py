"""Entry points of the serving hot loop into the kernels.

Counterpart of ``repro.kernels.ops`` (``quantize_experts_fp4``,
``grouped_fp4_ffn``).  Dispatch is by the device of the tensor: a CPU tensor
takes the plain PyTorch version, a CUDA tensor launches the CUDA kernel or
raises.  Nothing (no switch, no environment variable) sends a CUDA tensor
to the plain version.  The kernels mask ragged edges themselves, so callers
pass real shapes (any token count, any d_ff that is a multiple of 32) with
no padding.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.quant import GROUP, QTensor, global_scale_for
from repro_torch.kernels import grouped_fp4_ffn as _ffn
from repro_torch.kernels import quantize_fp4 as _quant


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {"quantize_fp4": _quant.launches,
            "grouped_fp4_ffn": _ffn.launches}


def reset_launch_counts() -> None:
    _quant.launches = 0
    _ffn.launches = 0


def quantize_experts_fp4(wt: torch.Tensor, *, group: int = GROUP) -> QTensor:
    """Quantize a ``[G, N, K]`` expert weight stack along K (any strides,
    e.g. ``w.transpose(-1, -2)`` of the ``[E, D, F]`` parameter).  Bitwise
    equal to ``quant.quantize_fp4`` (one global scale over the stack)."""
    gscale = global_scale_for(wt)
    if wt.device.type == "cpu":
        packed, scales = _quant.quantize_fp4_plain(wt, gscale, group)
    else:
        if group != GROUP:
            raise ValueError(f"the CUDA quantizer is built for group {GROUP}")
        packed, scales = _quant.quantize_fp4_cuda(wt, gscale)
    return QTensor(packed, scales, gscale)


def grouped_fp4_ffn(xs: torch.Tensor, gs: torch.Tensor,
                    wq: Dict[str, QTensor], *,
                    group: int = GROUP) -> torch.Tensor:
    """Fused grouped FP4 SwiGLU FFN over slot-sorted rows ``xs [M, D]`` with
    per-slot counts ``gs [G]``.  ``wq`` holds ``w_gate``/``w_up`` quantized
    along D and ``w_down`` along d_ff, with G rows each, as
    ``ep_moe._quantize_experts`` produces them."""
    qg, qu, qd = wq["w_gate"], wq["w_up"], wq["w_down"]
    gscales = torch.stack([qg.global_scale.reshape(()),
                           qu.global_scale.reshape(()),
                           qd.global_scale.reshape(())]).to(torch.float32)
    args = (xs, gs, qg.packed, qg.scales, qu.packed, qu.scales,
            qd.packed, qd.scales, gscales)
    if xs.device.type == "cpu":
        return _ffn.grouped_fp4_ffn_plain(*args, group=group)
    if group != GROUP:
        raise ValueError(f"the CUDA FFN kernel is built for group {GROUP}")
    return _ffn.grouped_fp4_ffn_cuda(*args)

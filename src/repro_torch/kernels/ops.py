"""Entry points into the kernels: the serving hot loop's and the kernels
package's own (``fp4_linear``).

Counterpart of ``repro.kernels.ops`` (``quantize_experts_fp4``,
``grouped_fp4_ffn``, ``quantize_fp4``, ``fp4_matmul``, ``fp4_linear``) and
of the reference MoE layer's BF16 expert FFN (``grouped_ffn``).  Dispatch
is by the device of the tensor: a CPU tensor takes the plain PyTorch
version, a CUDA tensor launches the CUDA kernel or raises.  Nothing (no
switch, no environment variable) sends a CUDA tensor to the plain version.
The kernels mask ragged edges themselves, so callers pass real shapes (any
token count, any d_ff that is a multiple of 32) with no padding, and no
block-size arguments.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.quant import GROUP, QTensor
from repro_torch.kernels import _build
from repro_torch.kernels import fp4_matmul as _mm
from repro_torch.kernels import grouped_fp4_ffn as _ffn
from repro_torch.kernels import quantize_fp4 as _quant


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, by kernel."""
    return {"quantize_fp4": _quant.launches,
            "global_scale_fp4": _quant.scale_launches,
            "grouped_fp4_ffn": _ffn.launches,
            "grouped_ffn": _ffn.plain_launches,
            "grouped_ffn_bwd": _ffn.bwd_launches,
            "fp4_matmul": _mm.launches}


def reset_launch_counts() -> None:
    _quant.launches = _quant.scale_launches = 0
    _ffn.launches = _ffn.plain_launches = _ffn.bwd_launches = 0
    _mm.launches = 0


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` (by kernel, as :func:`launch_counts` names them) to
    the counters: a CUDA graph's replay adds the launches its capture
    recorded, and a capture, which launches nothing, takes back the counts
    its wrappers added."""
    _quant.launches += delta.get("quantize_fp4", 0)
    _quant.scale_launches += delta.get("global_scale_fp4", 0)
    _ffn.launches += delta.get("grouped_fp4_ffn", 0)
    _ffn.plain_launches += delta.get("grouped_ffn", 0)
    _ffn.bwd_launches += delta.get("grouped_ffn_bwd", 0)
    _mm.launches += delta.get("fp4_matmul", 0)


def prepare_capture(device: torch.device) -> None:
    """Make what a kernel makes at its first launch before a CUDA graph
    captures one: the kernel libraries built and loaded, and the global
    scale's scratch made and zeroed on ``device`` (a card; nothing on the
    CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    _build.load()
    _quant.scale_scratch(device)


def _check_group(group: int, what: str) -> None:
    if group != GROUP:
        raise ValueError(f"the CUDA {what} is built for group {GROUP}")


def quantize_experts_fp4(wt: torch.Tensor, *, group: int = GROUP,
                         pred: Optional[torch.Tensor] = None) -> QTensor:
    """Quantize a ``[G, N, K]`` expert weight stack along K (any strides,
    e.g. ``w.transpose(-1, -2)`` of the ``[E, D, F]`` parameter).  Bitwise
    equal to ``quant.quantize_fp4`` (one global scale over the stack).
    ``pred``: ReaLB's FP4 decision as a 0-dim tensor on ``wt``'s device;
    when it is 0 nothing is computed (on the card the kernels exit at once
    and the returned tensors hold whatever was in memory; on the CPU they
    are zeros)."""
    if wt.device.type == "cpu":
        gscale = _quant.global_scale_plain(wt, pred)
        packed, scales = _quant.quantize_fp4_plain(wt, gscale, group, pred)
    else:
        _check_group(group, "quantizer")
        gscale = _quant.global_scale_cuda(wt, pred)
        packed, scales = _quant.quantize_fp4_cuda(wt, gscale, pred)
    return QTensor(packed, scales, gscale)


def grouped_fp4_ffn(xs: torch.Tensor, gs: torch.Tensor,
                    wq: Dict[str, QTensor], *,
                    group: int = GROUP) -> torch.Tensor:
    """Fused grouped FP4 SwiGLU FFN over slot-sorted rows ``xs [M, D]`` with
    per-slot counts ``gs [G]``.  ``wq`` holds ``w_gate``/``w_up`` quantized
    along D and ``w_down`` along d_ff, with ``Gw <= G`` rows each, as
    ``ep_moe._quantize_experts`` produces them; rows of slots past ``Gw``
    give 0."""
    qg, qu, qd = wq["w_gate"], wq["w_up"], wq["w_down"]
    gscales = torch.stack([qg.global_scale.reshape(()),
                           qu.global_scale.reshape(()),
                           qd.global_scale.reshape(())]).to(torch.float32)
    args = (xs, gs, qg.packed, qg.scales, qu.packed, qu.scales,
            qd.packed, qd.scales, gscales)
    if xs.device.type == "cpu":
        return _ffn.grouped_fp4_ffn_plain(*args, group=group)
    _check_group(group, "FFN kernel")
    return _ffn.grouped_fp4_ffn_cuda(*args)


def _grouped_ffn_fwd(xs, gs, w_gate, w_up, w_down) -> torch.Tensor:
    if xs.device.type == "cpu":
        return _ffn.grouped_ffn_plain(xs, gs, w_gate, w_up, w_down)
    return _ffn.grouped_ffn_cuda(xs, gs, w_gate, w_up, w_down)


class GroupedFFN(torch.autograd.Function):
    """:func:`grouped_ffn` with its gradient: the forward kernel (plain
    version on the CPU), and in backward the backward kernel (plain version
    on the CPU), which recomputes the pre-activations from the saved
    inputs.  ``gs`` takes no gradient."""

    @staticmethod
    def forward(ctx, xs, gs, w_gate, w_up, w_down):
        ctx.save_for_backward(xs, gs, w_gate, w_up, w_down)
        return _grouped_ffn_fwd(xs, gs, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dy):
        xs, gs, w_gate, w_up, w_down = ctx.saved_tensors
        bwd = _ffn.grouped_ffn_bwd_plain if xs.device.type == "cpu" \
            else _ffn.grouped_ffn_bwd_cuda
        dxs, dwg, dwu, dwd = bwd(xs, gs, w_gate, w_up, w_down,
                                 dy.contiguous())
        return dxs, None, dwg, dwu, dwd


def grouped_ffn(xs: torch.Tensor, gs: torch.Tensor,
                w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Grouped SwiGLU FFN with the plain expert weights ``w_gate``/``w_up
    [Gw, D, F]`` and ``w_down [Gw, F, D]`` (the reference's
    ``_grouped_ffn``); rows of slots past ``Gw`` give 0.  When autograd
    records and ``xs`` or a weight requires a gradient, the call goes
    through :class:`GroupedFFN` (the weights cast to ``xs``'s dtype
    first, so their gradients come back in their own dtype); otherwise it
    is the forward launch alone."""
    ws = (w["w_gate"], w["w_up"], w["w_down"])
    if torch.is_grad_enabled() and (xs.requires_grad
                                    or any(t.requires_grad for t in ws)):
        return GroupedFFN.apply(xs, gs, *(t.to(xs.dtype) for t in ws))
    return _grouped_ffn_fwd(xs, gs, *ws)


def quantize_fp4(w: torch.Tensor, *, group: int = GROUP
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NVFP4-quantize ``w [N, K]`` (any strides) along K with its own
    global scale.  Returns ``(packed [N, K/2], scales [N, K/group],
    gscale)``; K must be a multiple of ``2·group``."""
    n, k = w.shape
    if k % (2 * group):
        raise ValueError(f"quantize_fp4: K {k} is not a multiple of "
                         f"{2 * group}")
    q = quantize_experts_fp4(w[None], group=group)
    return q.packed[0], q.scales[0], q.global_scale.reshape(())


def fp4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
               global_scale: torch.Tensor, *, group: int = GROUP,
               a4: bool = False, out_dtype=torch.float32) -> torch.Tensor:
    """``x [M, K] @ Wᵀ`` with W stored as packed NVFP4 ``[N, K/2]``: any M
    and N, K a multiple of ``2·group``."""
    if x.device.type == "cpu":
        return _mm.fp4_matmul_plain(x, packed, scales, global_scale, a4=a4,
                                    group=group, out_dtype=out_dtype)
    _check_group(group, "W4A4 GEMM")
    return _mm.fp4_matmul_cuda(x, packed, scales, global_scale, a4=a4,
                               out_dtype=out_dtype)


def fp4_linear(x: torch.Tensor, w: torch.Tensor, *, a4: bool = False,
               group: int = GROUP) -> torch.Tensor:
    """Quantize-then-matmul (the on-the-fly transformation plus the GEMM):
    ``x [M, K] @ w [K, N] → [M, N]`` f32 with NVFP4 weight (and optionally
    activation) numerics."""
    packed, scales, gs = quantize_fp4(w.transpose(0, 1), group=group)
    return fp4_matmul(x, packed, scales, gs, group=group, a4=a4)

"""Grouped SwiGLU expert FFN, FP4 (W4A4) and plain: the CUDA kernels, their
plain versions, their counters.

Counterpart of ``repro.kernels.grouped_fp4_ffn`` (the Pallas
``grouped_fp4_ffn_kernel``) and of the reference MoE layer's BF16 branch
(``_grouped_ffn``: three ``jax.lax.ragged_dot``).  Over slot-sorted rows
``xs [M, D]`` with per-slot counts ``gs [G]``:

* FP4: ``xq = a4(x)``; ``gate, up = xq·deq(W)ᵀ``; ``h = silu(gate)·up``;
  ``y = a4(h)·deq(Wd)ᵀ``, with gate/up quantized along D (``[Gw, F, D/2]`` +
  ``[Gw, F, D/16]``), down along F (``[Gw, D, F/2]`` + ``[Gw, D, F/16]``) and
  three global scales;
* plain: ``g = x·Wg``, ``u = x·Wu``, ``h = silu(g)·u``, ``y = h·Wd`` with
  ``w_gate``/``w_up [Gw, D, F]`` and ``w_down [Gw, F, D]``, each product
  accumulated in f32 and cast to x's dtype.

``gs`` may be longer than the weight stacks (``Gw`` slots): rows of slots
``g >= Gw`` give 0, as do rows past ``sum(gs)``.  The MoE layer's pad slot
of unfilled capacity rows (all zero) is such a slot.  The kernel source is
``csrc/grouped_fp4_ffn.cu``; the plain versions are the reference's jnp
oracles (dequantize, then one product per slot) and run on the CPU only.

The plain FFN's gradient (training) is a kernel too,
``csrc/grouped_ffn_bwd.cu`` (``grouped_ffn_bwd_cuda``; bf16 on the tensor
cores, ``csrc/grouped_ffn_bwd_sm90.cuh``), beside its plain version
``grouped_ffn_bwd_plain``: ``dxs`` and the three weight gradients from
``dy``, recomputing ``g`` and ``u`` as the forward rounds them, with f32
accumulation and the roundings of ``jax.vjp`` of the reference.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.kernels import _build, working
from repro_torch.kernels.nvfp4 import fake_quant_a4

MAX_SLOTS = 512     # counts the bf16 kernels' device schedule takes

launches = 0        # kernel launches made by grouped_fp4_ffn_cuda
plain_launches = 0  # kernel launches made by grouped_ffn_cuda
bwd_launches = 0    # kernel launches made by grouped_ffn_bwd_cuda

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
              ctypes.c_int64] + [ctypes.c_void_p] * 11
             + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
_PLAIN_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                  ctypes.c_int64] + [ctypes.c_void_p] * 11
                 + [ctypes.c_int64] * 3 + [ctypes.c_void_p])
_ENTRY = {torch.bfloat16: "grouped_fp4_ffn_bf16",
          torch.float32: "grouped_fp4_ffn_f32"}
_PLAIN_ENTRY = {torch.bfloat16: "grouped_ffn_bf16",
                torch.float32: "grouped_ffn_f32"}
_BWD_ENTRY = {torch.bfloat16: "grouped_ffn_bwd_bf16",
              torch.float32: "grouped_ffn_bwd_f32"}


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, gs: torch.Tensor
                   ) -> torch.Tensor:
    """Ragged product: rows of group g (``gs[g]`` consecutive rows) times
    ``w[g] [K, N]``, f32 accumulate, cast to x's dtype; rows past
    ``sum(gs)`` and rows of groups past ``w.shape[0]`` are 0
    (``jax.lax.ragged_dot`` semantics).  It reads ``gs`` on the host."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=x.dtype,
                      device=x.device)
    r0 = 0
    for g, c in enumerate(gs.tolist()):
        if c and g < w.shape[0]:
            out[r0:r0 + c] = torch.matmul(x[r0:r0 + c], w[g])
        r0 += c
    return out


def grouped_outer(a: torch.Tensor, b: torch.Tensor, gs: torch.Tensor,
                  n_g: int) -> torch.Tensor:
    """``[n_g, Ka, Nb]``: slot g's rows of ``a [M, Ka]`` transposed times
    its rows of ``b [M, Nb]`` (a weight gradient of :func:`grouped_matmul`),
    in ``a``'s dtype; slots without rows give 0.  It reads ``gs`` on the
    host."""
    out = torch.zeros((n_g, a.shape[1], b.shape[1]), dtype=a.dtype,
                      device=a.device)
    r0 = 0
    for g, c in enumerate(gs.tolist()):
        if c and g < n_g:
            out[g] = torch.matmul(a[r0:r0 + c].t(), b[r0:r0 + c])
        r0 += c
    return out


def grouped_ffn_plain(xs, gs, w_gate, w_up, w_down) -> torch.Tensor:
    """The plain kernel's function in plain PyTorch (the reference's
    ``_grouped_ffn``)."""
    dt = xs.dtype
    g = grouped_matmul(xs, w_gate.to(dt), gs)
    u = grouped_matmul(xs, w_up.to(dt), gs)
    h = F.silu(g.to(torch.float32)).to(dt) * u
    return grouped_matmul(h, w_down.to(dt), gs)


def grouped_ffn_bwd_plain(xs, gs, w_gate, w_up, w_down, dy):
    """The backward kernel's function in plain PyTorch: ``(dxs, dw_gate,
    dw_up, dw_down)`` of :func:`grouped_ffn_plain` at ``dy``, in explicit
    formulas.  With ``T`` the rounding to ``xs``'s dtype, every product
    accumulated in f32 and ``s = sigmoid(g)``::

        g = T(x·Wg), u = T(x·Wu), a = T(silu(g)), h = T(a·u)  (the forward's)
        dh = T(dy·Wdᵀ)
        da = T(dh·u), du = T(dh·a)
        dg = T(da · s·(1 + g·(1 − s)))         (the derivative in f32)
        dx = T(T(dg·Wgᵀ) + T(du·Wuᵀ))
        dWg = T(xᵀ·dg), dWu = T(xᵀ·du), dWd = T(hᵀ·dy)

    These are the roundings of ``jax.vjp`` of the reference's
    ``_grouped_ffn``, where every cotangent takes its primal's dtype and
    the two uses of ``x`` add their cotangents in that dtype.  In f32 each
    ``T`` is the identity.  f64 inputs evaluate the chain in f64 (the
    yardstick the f32 entries are measured against)."""
    dt = xs.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32

    def rnd(t):
        return t.to(dt).to(acc)

    x = xs.to(acc)
    wg, wu, wd = (w.to(dt).to(acc) for w in (w_gate, w_up, w_down))
    n_g = wg.shape[0]
    g = rnd(grouped_matmul(x, wg, gs))
    u = rnd(grouped_matmul(x, wu, gs))
    s = torch.sigmoid(g)
    a = rnd(F.silu(g))
    h = rnd(a * u)
    dyf = dy.to(acc)
    dh = rnd(grouped_matmul(dyf, wd.transpose(-1, -2), gs))
    da = rnd(dh * u)
    du = rnd(dh * a)
    dg = rnd(da * (s * (1.0 + g * (1.0 - s))))
    dx = rnd(grouped_matmul(dg, wg.transpose(-1, -2), gs)) \
        + rnd(grouped_matmul(du, wu.transpose(-1, -2), gs))
    return (dx.to(dt), grouped_outer(x, dg, gs, n_g).to(w_gate.dtype),
            grouped_outer(x, du, gs, n_g).to(w_up.dtype),
            grouped_outer(h, dyf, gs, n_g).to(w_down.dtype))


def grouped_fp4_ffn_plain(xs, gs, gate_packed, gate_scales, up_packed,
                          up_scales, down_packed, down_scales, global_scales,
                          group: int = quant.GROUP) -> torch.Tensor:
    """The FP4 kernel's function in plain PyTorch."""
    dtype = xs.dtype

    def dq_t(packed, scales, gsc):     # [G, N, K] codes -> [G, K, N] dtype
        w = quant.dequantize_fp4(quant.QTensor(packed, scales, gsc))
        return w.transpose(-1, -2).to(dtype)

    xq = fake_quant_a4(xs, group).to(dtype)
    g = grouped_matmul(xq, dq_t(gate_packed, gate_scales, global_scales[0]),
                       gs)
    u = grouped_matmul(xq, dq_t(up_packed, up_scales, global_scales[1]), gs)
    h = F.silu(g.to(torch.float32)).to(dtype) * u
    hq = fake_quant_a4(h, group).to(dtype)
    return grouped_matmul(hq, dq_t(down_packed, down_scales,
                                   global_scales[2]), gs)


def _require_cuda(name, xs):
    if xs.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")


def _common_args(name, xs, gs, weights, n_g, d, f):
    """Validated contiguous inputs of one launch."""
    dev = xs.device
    if xs.dtype not in _ENTRY:
        raise TypeError(f"{name}: unsupported dtype {xs.dtype}")
    if d % 32 or f % 32 or gs.dim() != 1 or gs.shape[0] < n_g:
        raise ValueError(f"{name}: bad shapes xs {tuple(xs.shape)} gs "
                         f"{tuple(gs.shape)} for {n_g} weight slots, "
                         f"d_ff {f}")
    args = [xs, gs.to(torch.int32)] + list(weights)
    args = [a.contiguous() for a in args]
    for a in args:
        if a.device != dev or a.data_ptr() % 16:
            raise ValueError(f"{name}: every input must be a 16-byte "
                             "aligned tensor on the device of xs")
    return args


def _fwd_buffers(xs, f: int, fp4: bool):
    """``(xq, nz, hq, out)`` of a forward launch over ``xs [M, D]`` with
    ``f`` hidden: the FP4 design's quantized rows (None for the plain
    one), the f32 design's zero-row flags (None in bf16), the hidden rows
    and the zero-filled output."""
    (m, d), dt, dev = xs.shape, xs.dtype, xs.device
    xq = torch.empty((m, d), dtype=dt, device=dev) if fp4 else None
    nz = torch.empty((m,), dtype=torch.int32, device=dev) \
        if dt == torch.float32 else None
    hq = torch.empty((m, f), dtype=dt, device=dev)
    out = torch.zeros((m, d), dtype=dt, device=dev)
    return xq, nz, hq, out


def _bwd_buffers(xs, w_gate, w_up, w_down):
    """``(dg, du, h, dxs, dws)`` of a backward launch: the tensor-core
    design (bf16) writes every element of its outputs; the FMA design
    (f32) takes them zeroed, and with no rows or no weights nothing
    launches and the outputs are zeros."""
    (m, d), dt, dev = xs.shape, xs.dtype, xs.device
    n_g, _, f = w_gate.shape
    alloc = torch.empty if dt == torch.bfloat16 and m and n_g \
        else torch.zeros
    dg, du, h = (torch.empty((m, f), dtype=dt, device=dev)
                 for _ in range(3))
    dxs = alloc((m, d), dtype=dt, device=dev)
    dws = [alloc(w.shape, dtype=dt, device=dev)
           for w in (w_gate, w_up, w_down)]
    return dg, du, h, dxs, dws


def grouped_fp4_ffn_meta(xs, gs, gate_packed, *rest) -> torch.Tensor:
    """The FP4 kernel's shape function on ``meta`` tensors: the buffers
    :func:`grouped_fp4_ffn_cuda` allocates, its output returned."""
    return _fwd_buffers(xs, gate_packed.shape[1], fp4=True)[3]


def grouped_ffn_meta(xs, gs, w_gate, w_up, w_down) -> torch.Tensor:
    """The plain kernel's shape function on ``meta`` tensors."""
    return _fwd_buffers(xs, w_gate.shape[2], fp4=False)[3]


def grouped_ffn_bwd_meta(xs, gs, w_gate, w_up, w_down, dy):
    """The backward kernel's shape function on ``meta`` tensors:
    ``(dxs, dw_gate, dw_up, dw_down)`` as :func:`grouped_ffn_bwd_cuda`
    allocates them."""
    _, _, _, dxs, dws = _bwd_buffers(xs, w_gate, w_up, w_down)
    return (dxs, *dws)


def grouped_fp4_ffn_cuda(xs, gs, gate_packed, gate_scales, up_packed,
                         up_scales, down_packed, down_scales, global_scales
                         ) -> torch.Tensor:
    """Launch the FP4 kernel (SwiGLU, group 16) on CUDA tensors; ``xs``
    bf16 or f32 with D and F multiples of 32 (bf16: at most ``MAX_SLOTS``
    counts)."""
    global launches
    _require_cuda("grouped_fp4_ffn_cuda", xs)
    m, d = xs.shape
    n_g, f, d2 = gate_packed.shape
    if d2 * 2 != d or down_packed.shape != (n_g, d, f // 2):
        raise ValueError(f"grouped_fp4_ffn_cuda: bad shapes xs "
                         f"{tuple(xs.shape)} gate {tuple(gate_packed.shape)}"
                         f" down {tuple(down_packed.shape)}")
    x, g32, gp, gsc, up, usc, dp, dsc, gscales = _common_args(
        "grouped_fp4_ffn_cuda", xs, gs,
        [gate_packed, gate_scales.float(), up_packed, up_scales.float(),
         down_packed, down_scales.float(),
         global_scales.to(torch.float32).reshape(3)], n_g, d, f)
    if xs.dtype == torch.bfloat16 and g32.shape[0] > MAX_SLOTS:
        raise ValueError(f"grouped_fp4_ffn_cuda: {g32.shape[0]} counts, the "
                         f"bf16 kernel takes at most {MAX_SLOTS}")
    dev = xs.device
    xq, nz, hq, out = _fwd_buffers(xs, f, fp4=True)
    fn = _build.entry("grouped_fp4_ffn", _ENTRY[xs.dtype], _ARGTYPES)
    err = fn(x.data_ptr(), g32.data_ptr(), g32.shape[0], n_g, gp.data_ptr(),
             gsc.data_ptr(), up.data_ptr(), usc.data_ptr(), dp.data_ptr(),
             dsc.data_ptr(), gscales.data_ptr(), xq.data_ptr(),
             None if nz is None else nz.data_ptr(), hq.data_ptr(),
             out.data_ptr(), m, d, f,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "grouped_fp4_ffn")
    launches += 1
    working.note("grouped_fp4_ffn",
                 lambda: (g32[:n_g] > 0).any())
    return out


def grouped_ffn_cuda(xs, gs, w_gate, w_up, w_down) -> torch.Tensor:
    """Launch the plain kernel (SwiGLU) on CUDA tensors: ``xs`` bf16 or f32,
    weights ``[Gw, D, F]``/``[Gw, F, D]`` cast to its dtype, D and F
    multiples of 32 (bf16: at most ``MAX_SLOTS`` counts)."""
    global plain_launches
    _require_cuda("grouped_ffn_cuda", xs)
    m, d = xs.shape
    n_g, d1, f = w_gate.shape
    if d1 != d or w_up.shape != w_gate.shape \
            or w_down.shape != (n_g, f, d):
        raise ValueError(f"grouped_ffn_cuda: bad shapes xs {tuple(xs.shape)}"
                         f" gate {tuple(w_gate.shape)} down "
                         f"{tuple(w_down.shape)}")
    dt = xs.dtype
    x, g32, wg, wu, wd = _common_args(
        "grouped_ffn_cuda", xs, gs,
        [w_gate.to(dt), w_up.to(dt), w_down.to(dt)], n_g, d, f)
    if dt == torch.bfloat16 and g32.shape[0] > MAX_SLOTS:
        raise ValueError(f"grouped_ffn_cuda: {g32.shape[0]} counts, the "
                         f"bf16 kernel takes at most {MAX_SLOTS}")
    dev = xs.device
    _, nz, hq, out = _fwd_buffers(xs, f, fp4=False)
    fn = _build.entry("grouped_fp4_ffn", _PLAIN_ENTRY[dt], _PLAIN_ARGTYPES)
    err = fn(x.data_ptr(), g32.data_ptr(), g32.shape[0], n_g, wg.data_ptr(),
             wu.data_ptr(), wd.data_ptr(),
             None if nz is None else nz.data_ptr(), hq.data_ptr(),
             out.data_ptr(), m, d, f,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "grouped_ffn")
    plain_launches += 1
    working.note("grouped_ffn",
                 lambda: (g32[:n_g] > 0).any())
    return out


def grouped_ffn_bwd_cuda(xs, gs, w_gate, w_up, w_down, dy):
    """Launch the backward kernel on CUDA tensors: ``xs`` and ``dy [M, D]``
    bf16 or f32, weights ``[Gw, D, F]``/``[Gw, F, D]`` of that dtype, D and
    F multiples of 32 (16-byte row strides for TMA), bf16 at most
    ``MAX_SLOTS`` counts; returns ``(dxs, dw_gate, dw_up, dw_down)``.  bf16
    is the tensor-core design, which writes every element of its outputs
    (bf16 ``dg``, ``du``, ``h`` scratch); f32 the FMA design, which takes
    zeroed outputs and f32 scratch."""
    global bwd_launches
    _require_cuda("grouped_ffn_bwd_cuda", xs)
    m, d = xs.shape
    n_g, d1, f = w_gate.shape
    dt = xs.dtype
    if d1 != d or w_up.shape != w_gate.shape \
            or w_down.shape != (n_g, f, d) or dy.shape != xs.shape:
        raise ValueError(f"grouped_ffn_bwd_cuda: bad shapes xs "
                         f"{tuple(xs.shape)} dy {tuple(dy.shape)} gate "
                         f"{tuple(w_gate.shape)} down {tuple(w_down.shape)}")
    if any(t.dtype != dt for t in (w_gate, w_up, w_down, dy)):
        raise TypeError("grouped_ffn_bwd_cuda: xs, dy and the weights must "
                        f"share one dtype, got {xs.dtype}, {dy.dtype}, "
                        f"{w_gate.dtype}, {w_up.dtype}, {w_down.dtype}")
    x, g32, wg, wu, wd, dyc = _common_args(
        "grouped_ffn_bwd_cuda", xs, gs, [w_gate, w_up, w_down, dy], n_g, d,
        f)
    tensor_cores = dt == torch.bfloat16
    if tensor_cores and g32.shape[0] > MAX_SLOTS:
        raise ValueError(f"grouped_ffn_bwd_cuda: {g32.shape[0]} counts, the "
                         f"bf16 kernel takes at most {MAX_SLOTS}")
    dev = xs.device
    dg, du, h, dxs, dws = _bwd_buffers(xs, w_gate, w_up, w_down)
    if m and n_g:
        fn = _build.entry("grouped_ffn_bwd", _BWD_ENTRY[dt], _BWD_ARGTYPES)
        err = fn(x.data_ptr(), g32.data_ptr(), g32.shape[0], n_g,
                 wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), dyc.data_ptr(),
                 dg.data_ptr(), du.data_ptr(), h.data_ptr(), dxs.data_ptr(),
                 dws[0].data_ptr(), dws[1].data_ptr(), dws[2].data_ptr(), m,
                 d, f, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "grouped_ffn_bwd")
        bwd_launches += 1
    return (dxs, *dws)

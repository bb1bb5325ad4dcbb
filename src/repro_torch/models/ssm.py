"""Mamba-1 selective SSM block of the port (falcon-mamba and jamba's mamba
layers).

Counterpart of ``repro.models.ssm``, with its shapes, parameter names and
roundings.  The selective scan ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``
runs over the sequence axis as :func:`associative_scan`, a copy of the
recursion of ``jax.lax.associative_scan`` (so the scan gives the
reference's bits, not a sequential loop's).  Decode keeps O(1) state a
layer: the conv window ``conv [B, d_conv-1, d_in]`` in the parameter dtype
and the SSM state ``ssm [B, d_in, N]`` in f32.

Everything here is plain PyTorch: the reference's SSM is ``jnp`` outside
any Pallas kernel, and its projections are ``einsum`` (here
``torch.matmul``).  In the tensor-parallel layout (``models.layout``)
``d_inner`` goes over ``model``: ``w_in`` column-parallel, ``w_x`` and
``w_out`` row-parallel, the conv, the scan and the cache per channel on
the rank's channels (so the recursion and its bits are unchanged).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models.common import P

Params = Dict[str, torch.Tensor]
F32 = torch.float32


def ssm_spec(cfg: ModelConfig) -> Dict[str, P]:
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    d_in = s.expand * d
    dtr = s.resolved_dt_rank(d)
    return {
        "w_in": P((d, 2 * d_in), axes=("embed", "d_inner")),
        "conv_w": P((s.d_conv, d_in), axes=(None, "d_inner")),
        "conv_b": P((d_in,), init="zeros", axes=("d_inner",)),
        "w_x": P((d_in, dtr + 2 * s.d_state), axes=("d_inner", None)),
        "w_dt": P((dtr, d_in), axes=(None, "d_inner")),
        "b_dt": P((d_in,), init="ones", dtype="float32", axes=("d_inner",)),
        "a_log": P((d_in, s.d_state), init="ones", dtype="float32",
                   axes=("d_inner", None)),
        "d_skip": P((d_in,), init="ones", dtype="float32",
                    axes=("d_inner",)),
        "w_out": P((d_in, d), axes=("d_inner", "embed")),
    }


def _interleave(even: torch.Tensor, odd: torch.Tensor,
                axis: int) -> torch.Tensor:
    """``[e0, o0, e1, o1, ...]`` along ``axis`` (``even`` has as many
    elements as ``odd`` or one more)."""
    n_odd = odd.shape[axis]
    pairs = torch.stack([even.narrow(axis, 0, n_odd), odd], dim=axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if even.shape[axis] > n_odd:
        out = torch.cat([out, even.narrow(axis, n_odd, 1)], dim=axis)
    return out


def _every_other(t: torch.Tensor, start: int, stop, axis: int
                 ) -> torch.Tensor:
    idx = [slice(None)] * t.dim()
    idx[axis] = slice(start, stop, 2)
    return t[tuple(idx)]


def associative_scan(fn: Callable[[List[torch.Tensor], List[torch.Tensor]],
                                  List[torch.Tensor]],
                     elems: List[torch.Tensor], axis: int
                     ) -> List[torch.Tensor]:
    """Inclusive scan of ``elems`` (tensors of one length along ``axis``)
    under the associative ``fn(a, b)``, by the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the half by
    recursion (the odd outputs), combine each odd output with the next
    even input (the even outputs), and interleave.  Every combine sees the
    operands the reference's sees, in the same order, so the result has
    its bits (elementwise ``fn`` of correctly rounded ops)."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = fn([_every_other(e, 0, -1, axis) for e in elems],
                 [_every_other(e, 1, None, axis) for e in elems])
    odd = associative_scan(fn, reduced, axis)
    if n % 2 == 0:
        even = fn([e.narrow(axis, 0, e.shape[axis] - 1) for e in odd],
                  [_every_other(e, 2, None, axis) for e in elems])
    else:
        even = fn(odd, [_every_other(e, 2, None, axis) for e in elems])
    even = [torch.cat([e.narrow(axis, 0, 1), r], dim=axis)
            for e, r in zip(elems, even)]
    return [_interleave(e, o, axis) for e, o in zip(even, odd)]


def _combine(e1: List[torch.Tensor], e2: List[torch.Tensor]
             ) -> List[torch.Tensor]:
    """The reference's scan operator on ``(decay, state)`` pairs."""
    a1, b1 = e1
    a2, b2 = e2
    return [a1 * a2, a2 * b1 + b2]


def _silu(v: torch.Tensor) -> torch.Tensor:
    return v * torch.sigmoid(v)


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(v, 0)``), which has no
    threshold."""
    return torch.clamp_min(v, 0) + torch.log1p(torch.exp(-torch.abs(v)))


def _ssm_core(p: Params, xz: torch.Tensor, conv_state: torch.Tensor,
              ssm_state: torch.Tensor, cfg: ModelConfig, seq_mode: bool,
              proj_sum=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The selective-SSM math shared by prefill and decode.

    xz: [B, S, 2*d_in] (parameter dtype); conv_state [B, d_conv-1, d_in];
    ssm_state [B, d_in, N] f32.  Returns (y [B, S, d_in] in xz's dtype,
    new conv_state, new ssm_state f32).  The casts are the reference's:
    the conv, the projections' products and ``dt`` before its ``w_dt``
    product round to the parameter dtype; silu, softplus and the scan run
    in f32.  ``proj_sum`` (the tensor-parallel layout's) sums the
    ``w_x`` product of a rank's channels over ``model``."""
    s_cfg = cfg.ssm or SSMConfig()
    n = s_cfg.d_state
    dt_x = xz.dtype
    x, z = torch.chunk(xz, 2, dim=-1)                       # [B,S,d_in]
    s = x.shape[1]

    # depthwise causal conv over the sequence with the carried history:
    # the reference's ordered sum over the taps
    hist = torch.cat([conv_state.to(dt_x), x], dim=1)
    dc = s_cfg.d_conv
    x_conv = hist[:, 0:s, :] * p["conv_w"][0].to(dt_x)[None, None]
    for i in range(1, dc):
        x_conv = x_conv + hist[:, i:i + s, :] * p["conv_w"][i].to(dt_x)[
            None, None]
    x_conv = x_conv + p["conv_b"].to(dt_x)[None, None]
    x_conv = _silu(x_conv.to(F32))                          # [B,S,d_in] f32
    new_conv_state = hist[:, hist.shape[1] - (dc - 1):, :] if dc > 1 \
        else hist[:, :0, :]

    # input-dependent dt, B, C
    dtr = p["w_dt"].shape[0]
    proj = torch.matmul(x_conv.to(dt_x), p["w_x"].to(dt_x))
    if proj_sum is not None:
        proj = proj_sum(proj)
    proj = proj.to(F32)
    dt, b_mat, c_mat = torch.split(proj, [dtr, n, n], dim=-1)
    dt = torch.matmul(dt.to(dt_x), p["w_dt"].to(dt_x)).to(F32)
    dt = _softplus(dt + p["b_dt"][None, None])              # [B,S,d_in]
    a = -torch.exp(p["a_log"])                              # [d_in,N]

    da = torch.exp(dt[..., None] * a[None, None])           # [B,S,d_in,N]
    dbx = dt[..., None] * b_mat[:, :, None, :] * x_conv[..., None]

    if seq_mode:
        # the carried state enters as step 0's decayed term, in place:
        # autograd records the write (no node saved dbx for its backward)
        dbx[:, 0] = dbx[:, 0] + da[:, 0] * ssm_state
        _, h = associative_scan(_combine, [da, dbx], axis=1)
        new_ssm_state = h[:, -1]                            # [B,d_in,N]
    else:
        h = (da[:, 0] * ssm_state + dbx[:, 0])[:, None]     # [B,1,d_in,N]
        new_ssm_state = h[:, 0]

    y = torch.matmul(h, c_mat[..., None])[..., 0]           # [B,S,d_in]
    y = y + x_conv * p["d_skip"][None, None]
    y = y * _silu(z.to(F32))
    return y.to(dt_x), new_conv_state.to(dt_x), new_ssm_state


def _tp_in(p: Params, cfg: ModelConfig, tp):
    """``(w_in, proj_sum, d_in)`` of a rank in the tensor-parallel layout
    (``models.layout``): its channels' columns of ``w_in``, whose
    ``d_inner`` dim the rules cut in one block over both halves (``x``,
    then ``z``), so the block is gathered over ``model`` and the rank's
    ``x`` and ``z`` columns taken (the gather's transpose reduce-scatters
    the gradient); the sum of the ``w_x`` product over ``model``, entered
    again (every rank's channels use all of ``dt``, ``B``, ``C``)."""
    s_cfg = cfg.ssm or SSMConfig()
    d_in = s_cfg.expand * cfg.d_model
    if tp is None:
        return p["w_in"], None, d_in
    lo, hi = tp.cut(d_in)
    w = tp.comm.fsdp_gather(p["w_in"], 1, "model", (
        "tp_weight_all_gather", "tp_weight_reduce_scatter"))
    w = torch.cat([w[:, lo:hi], w[:, d_in + lo:d_in + hi]], dim=1)
    return w, (lambda t: tp.enter(tp.psum(t))), hi - lo


def ssm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, tp=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Whole-sequence mamba block from zero state. x: [B,S,D] -> (out,
    final states ``{"conv", "ssm"}``).  ``tp`` (``models.layout.TP``):
    ``x`` is the residual's layout; the rank's ``d_inner`` channels run
    on the whole sequence (``w_in`` column-, ``w_x`` and ``w_out``
    row-parallel) and their states are returned; a ``d_inner`` that does
    not divide runs whole, the rank's rows kept."""
    s_cfg = cfg.ssm or SSMConfig()
    d_in = s_cfg.expand * cfg.d_model
    if tp is not None and not tp.divides(d_in):
        xs = tp.comm.gather_cat(x, 1) if tp.sp else x
        out, st = ssm_forward(p, xs, cfg)
        return tp.own_rows(out), st
    w_in, proj_sum, d_loc = _tp_in(p, cfg, tp)
    if tp is not None:
        x = tp.gather_seq(x)
    xz = torch.matmul(x, w_in.to(x.dtype))
    b = x.shape[0]
    conv0 = torch.zeros((b, s_cfg.d_conv - 1, d_loc), dtype=x.dtype,
                        device=x.device)
    ssm0 = torch.zeros((b, d_loc, s_cfg.d_state), dtype=F32,
                       device=x.device)
    y, conv_st, ssm_st = _ssm_core(p, xz, conv0, ssm0, cfg, seq_mode=True,
                                   proj_sum=proj_sum)
    out = torch.matmul(y, p["w_out"].to(x.dtype))
    if tp is not None:
        out = tp.reduce_out(out)
    return out, {"conv": conv_st, "ssm": ssm_st}


def ssm_decode(p: Params, x: torch.Tensor, state: Dict[str, torch.Tensor],
               cfg: ModelConfig, tp=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step. x: [B,1,D]; state: conv [B,dc-1,d_in], ssm
    [B,d_in,N] -> (out, new states); the caller writes them back.
    ``tp``: the rank's channels (its slice of the state), the output
    summed over ``model``."""
    s_cfg = cfg.ssm or SSMConfig()
    if tp is not None and not tp.divides(s_cfg.expand * cfg.d_model):
        return ssm_decode(p, x, state, cfg)
    w_in, proj_sum, _ = _tp_in(p, cfg, tp)
    xz = torch.matmul(x, w_in.to(x.dtype))
    y, conv_st, ssm_st = _ssm_core(p, xz, state["conv"], state["ssm"], cfg,
                                   seq_mode=False, proj_sum=proj_sum)
    out = torch.matmul(y, p["w_out"].to(x.dtype))
    if tp is not None:
        out = tp.psum(out)
    return out, {"conv": conv_st, "ssm": ssm_st}

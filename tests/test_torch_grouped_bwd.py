"""The grouped SwiGLU FFN's gradient on the CPU: ``kernels.ops.grouped_ffn``
under autograd (the forward's and the backward kernel's plain versions)
against autograd of ``grouped_ffn_plain`` and against ``jax.vjp`` of the
reference's ``_grouped_ffn`` (``src/repro/core/ep_moe.py:330``), at the
kernels' tolerance, rtol 1e-5 / atol 1e-4, in f32; the plain backward
in bf16 against ``jax.vjp`` in bf16, element for element; and, at
moonshot's width, the f32 spread of the reference and of the plain version
against an f64 evaluation (``_torch_bwd_wide.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_bwd_wide as bw
from repro.core import ep_moe as jmoe
from repro_torch.kernels import grouped_fp4_ffn as ffn
from repro_torch.kernels import ops

# (m, d, f, gs, Gw): empty groups; rows past sum(gs); Gw < G (the last slot
# without weights, its rows nonzero); all-zero counts; a wider pattern
CASES = [
    (24, 64, 64, [3, 0, 5, 0, 0, 9, 7, 0, 0], 9),
    (40, 64, 96, [10, 0, 12], 3),
    (37, 64, 64, [10, 0, 12, 15], 3),
    (16, 64, 64, [0, 0, 0], 3),
    (300, 256, 192, [70, 0, 1, 64, 65, 0, 0, 40, 60], 8),
]
TOL = dict(rtol=1e-5, atol=1e-4)


def _inputs(m, d, f, gs, n_w, seed):
    rng = np.random.default_rng(seed)
    scale = 0.3 * min(1.0, (64 / d) ** 0.5)
    x = rng.normal(0, 1, (m, d)).astype(np.float32)
    w = [(rng.normal(0, 1, shape) * scale).astype(np.float32)
         for shape in ((n_w, d, f), (n_w, d, f), (n_w, f, d))]
    dy = rng.normal(0, 1, (m, d)).astype(np.float32)
    return x, np.asarray(gs, np.int32), w, dy


def _reference_vjp(x, gs, w, dy, dtype=jnp.float32):
    """jax.vjp of the reference's _grouped_ffn, its inputs cast to
    ``dtype``; slots past Gw get zero weights (ragged_dot takes one weight
    slab a group), so their rows give 0, as the port's give."""
    pad = len(gs) - w[0].shape[0]
    wj = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
          for a in w]

    def fn(x, wg, wu, wd):
        return jmoe._grouped_ffn(x, jnp.asarray(gs), wg, wu, wd, jax.nn.silu)

    y, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in (x, *wj)))
    grads = vjp(jnp.asarray(dy, dtype))
    n_w = w[0].shape[0]
    return (np.asarray(y), np.asarray(grads[0]),
            *(np.asarray(g)[:n_w] for g in grads[1:]))


@pytest.mark.parametrize("m,d,f,gs,n_w", CASES)
def test_autograd_matches_plain_autograd_and_reference(m, d, f, gs, n_w):
    x, gsn, w, dy = _inputs(m, d, f, gs, n_w, m + d + n_w)
    gst = torch.from_numpy(gsn)

    def run(fn):
        xt = torch.from_numpy(x).requires_grad_()
        wt = [torch.from_numpy(a).requires_grad_() for a in w]
        y = fn(xt, wt)
        if not y.requires_grad:    # plain, all-zero counts: a constant 0
            return (y, torch.zeros_like(xt),
                    *(torch.zeros_like(a) for a in wt))
        y.backward(torch.from_numpy(dy))
        return (y.detach(), xt.grad, *(a.grad for a in wt))

    ops.reset_launch_counts()
    got = run(lambda xt, wt: ops.grouped_ffn(
        xt, gst, dict(zip(("w_gate", "w_up", "w_down"), wt))))
    assert set(ops.launch_counts().values()) == {0}   # the CPU: no kernel
    plain = run(lambda xt, wt: ffn.grouped_ffn_plain(xt, gst, *wt))
    ref = _reference_vjp(x, gsn, w, dy)
    for name, a, b, r in zip(("y", "dxs", "dw_gate", "dw_up", "dw_down"),
                             got, plain, ref):
        torch.testing.assert_close(a, b, msg=name, **TOL)
        np.testing.assert_allclose(a.numpy(), r, err_msg=name, **TOL)
    live = sum(gs[:n_w])
    assert torch.all(got[1][live:] == 0)
    if not any(gs):
        assert all(torch.all(t == 0) for t in got)


def test_backward_plain_is_the_autograd_function_backward():
    """The autograd function's CPU backward is ``grouped_ffn_bwd_plain``,
    and without a gradient the call is the bare forward."""
    x, gsn, w, dy = _inputs(37, 64, 64, [10, 0, 12, 15], 3, 1)
    gst = torch.from_numpy(gsn)
    args = [torch.from_numpy(a) for a in (x, *w)]
    want = ffn.grouped_ffn_bwd_plain(args[0], gst, *args[1:],
                                     torch.from_numpy(dy))
    xt = args[0].clone().requires_grad_()
    y = ops.GroupedFFN.apply(xt, gst, *args[1:])
    y.backward(torch.from_numpy(dy))
    assert torch.equal(xt.grad, want[0])
    with torch.no_grad():
        y2 = ops.grouped_ffn(xt, gst, dict(zip(("w_gate", "w_up", "w_down"),
                                              args[1:])))
    assert not y2.requires_grad
    assert torch.equal(y2, ffn.grouped_ffn_plain(args[0], gst, *args[1:]))


def test_backward_plain_bf16_rounds_like_the_forward():
    """In bf16 the plain backward recomputes g and u rounded to bf16 as the
    forward rounds them and returns bf16 gradients; it agrees with the f32
    backward on the same (bf16-representable) inputs to bf16 precision."""
    x, gsn, w, dy = _inputs(40, 64, 96, [10, 0, 12], 3, 2)
    gst = torch.from_numpy(gsn)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, *w, dy)]
    got = ffn.grouped_ffn_bwd_plain(bf[0], gst, *bf[1:])
    assert all(t.dtype == torch.bfloat16 for t in got)
    ref = ffn.grouped_ffn_bwd_plain(*[t.float() for t in bf[:1]], gst,
                                    *[t.float() for t in bf[1:]])
    for a, r in zip(got, ref):
        tol = 2.0 ** -5 * float(r.abs().max())
        torch.testing.assert_close(a.float(), r, rtol=2.0 ** -5, atol=tol)


# the slot sizes around a 64-row tile's edges; bitwise in bf16
EDGE_CASE = (224, 64, 64, [1, 17, 63, 64, 65], 5)
BITWISE_CASES = CASES[:4] + [EDGE_CASE]
NEAR_CASES = [CASES[4],
              (600, 512, 384, [140, 0, 2, 128, 130, 0, 0, 80, 120], 8)]


@pytest.mark.parametrize("m,d,f,gs,n_w", BITWISE_CASES + NEAR_CASES)
def test_backward_plain_bf16_matches_reference_vjp(m, d, f, gs, n_w):
    """In bf16 the plain backward rounds where ``jax.vjp`` of the
    reference's ``_grouped_ffn`` rounds (every cotangent in its primal's
    dtype, the two cotangents of ``x`` added in bf16).  Bitwise on the
    small cases; on the larger ones the sums of 256-512 terms run in
    another order than XLA's, so a few elements sit one bf16 ulp apart:
    at least 99.5 % of each output bitwise equal, the rest within 2^-7 of
    its largest magnitude."""
    x, gsn, w, dy = _inputs(m, d, f, gs, n_w, m + d + n_w)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, *w, dy)]
    got = ffn.grouped_ffn_bwd_plain(bf[0], torch.from_numpy(gsn), *bf[1:])
    f32 = [t.float().numpy() for t in bf]
    ref = _reference_vjp(f32[0], gsn, f32[1:4], f32[4], jnp.bfloat16)[1:]
    bitwise = (m, d, f, gs, n_w) in BITWISE_CASES
    for name, a, r in zip(("dxs", "dw_gate", "dw_up", "dw_down"), got, ref):
        assert a.dtype == torch.bfloat16, name
        a = a.float().numpy()
        r = np.asarray(r.astype(np.float32))
        assert a.shape == r.shape, name
        if bitwise:
            np.testing.assert_array_equal(a, r, err_msg=name)
            continue
        equal = float(np.mean(a == r))
        assert equal >= 0.995, f"{name}: {equal:.4%} bitwise equal"
        gap = float(np.max(np.abs(a - r)))
        assert gap <= 2.0 ** -7 * float(np.max(np.abs(r))), (name, gap)


@pytest.mark.parametrize("n_w", bw.N_W)
def test_f32_spread_at_moonshot_width(n_w):
    """At D = 2048 the f32 backward's own rounding exceeds the kernels'
    atol of 1e-4, in the reference too.  Against an f64 evaluation of the
    same chain on ``bw.inputs``: ``jax.vjp`` of the reference's
    ``_grouped_ffn`` in f32 is off by ~2e-4 in every weight gradient
    (``bw.REF_F64_GAP``, the card's yardstick, held here within 2 %); the
    port's plain version in f32 (these BLAS sums measured 1.3-2.2x the
    reference's distance) within the same f32 order, ``PLAIN_ORDER`` x.
    The card holds the f32 CUDA entry within ``bw.RATIO`` x both
    (``test_torch_cuda.py::test_grouped_ffn_bwd_f32_within_the_f32_spread``)."""
    x, gs, w, dy = bw.inputs(n_w)
    ref = _reference_vjp(x, gs, w, dy)[1:]
    gst = torch.from_numpy(gs)
    plain = ffn.grouped_ffn_bwd_plain(
        torch.from_numpy(x), gst, *(torch.from_numpy(a) for a in w),
        torch.from_numpy(dy))
    f64 = ffn.grouped_ffn_bwd_plain(
        torch.from_numpy(x).double(), gst,
        *(torch.from_numpy(a).double() for a in w),
        torch.from_numpy(dy).double())
    assert all(t.dtype == torch.float64 for t in f64)
    ref_gap, plain_gap = bw.gaps(ref, f64), bw.gaps(plain, f64)
    for name in bw.OUTPUTS:
        assert ref_gap[name] == pytest.approx(bw.REF_F64_GAP[n_w][name],
                                              rel=0.02), (name, ref_gap)
        assert plain_gap[name] <= PLAIN_ORDER * ref_gap[name], (name,
                                                                plain_gap)
    # the reference itself sits past atol 1e-4 in every weight gradient
    assert min(ref_gap[n] for n in bw.OUTPUTS[1:]) > 1e-4


PLAIN_ORDER = 4.0

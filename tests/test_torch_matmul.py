"""The port's ``fp4_linear`` path against the reference on the CPU: the 2-D
quantizer, the W4(A4) GEMM's plain version, ``kernels/ref`` and the rest of
``core/quant`` (``fp4_sim``, ``quant_error``, ``matmul_w4a16/a4``).

The Pallas kernels run in interpret mode, jitted as the engine runs them
(eager JAX divides by constants where jitted XLA multiplies by their f32
reciprocal; the port mirrors the jitted form).  Inputs are numpy-seeded.
The CUDA kernel against the plain version is in tests/test_torch_cuda.py.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import tensor_from_numpy, to_numpy
from repro_torch.core import quant as tquant
from repro_torch.kernels import fp4_matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the reference's kernel test shapes (tests/test_kernels.py)
SHAPES = [(128, 256, 512), (64, 128, 128), (256, 384, 1024), (8, 128, 64)]
ODD_SHAPES = [(37, 130, 96), (5, 17, 64), (100, 200, 544), (1, 1, 32)]
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}

_quantize = jax.jit(partial(jops.quantize_fp4, interpret=True))
_matmul = jax.jit(partial(jops.fp4_matmul, interpret=True),
                  static_argnames=("a4",))
_linear = jax.jit(partial(jops.fp4_linear, interpret=True),
                  static_argnames=("a4",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    assert int((a != b).sum()) == 0, f"{int((a != b).sum())} differ"


def _operands(m, n, k, dtype, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)


@pytest.mark.parametrize("m,n,k", SHAPES + ODD_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantize_2d_matches_pallas(m, n, k, dtype):
    _, w = _operands(m, n, k, DTYPES[dtype], n * k)
    pk, sc, gs = _quantize(w)
    pk_t, sc_t, gs_t = tops.quantize_fp4(_t(w))
    _bits_equal(pk, pk_t.numpy())
    _bits_equal(sc, sc_t.numpy())
    _bits_equal(gs, gs_t.numpy())
    # the oracle, given the same global scale
    pk_r, sc_r = tref.quantize_fp4_ref(_t(w), gs_t)
    _bits_equal(pk, pk_r.numpy())
    _bits_equal(sc, sc_r.numpy())


@pytest.mark.parametrize("m,n,k", SHAPES + ODD_SHAPES)
@pytest.mark.parametrize("a4", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fp4_matmul_plain_matches_pallas_and_oracle(m, n, k, a4, dtype):
    x, w = _operands(m, n, k, DTYPES[dtype], m + n + k)
    pk, sc, gs = _quantize(w)
    y_pallas = _matmul(x, pk, sc, gs, a4=a4)
    y_oracle = jref.fp4_matmul_ref(x, pk, sc, gs, a4=a4)
    y = tops.fp4_matmul(_t(x), _t(pk), _t(sc), _t(gs), a4=a4)
    assert y.shape == (m, n) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_oracle), rtol=1e-5,
                               atol=1e-4)
    # the port's own oracle
    y_ref = tref.fp4_matmul_ref(_t(x), _t(pk), _t(sc), _t(gs), a4=a4)
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(y_oracle),
                               rtol=1e-5, atol=1e-4)


def test_fp4_matmul_out_dtype_bf16():
    """out_dtype=bf16 is the f32 product rounded once."""
    x, w = _operands(37, 130, 96, jnp.float32, 5)
    pk, sc, gs = _quantize(w)
    args = (_t(x), _t(pk), _t(sc), _t(gs))
    y16 = tops.fp4_matmul(*args, out_dtype=torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    assert torch.equal(y16, tops.fp4_matmul(*args).to(torch.bfloat16))


def test_plain_version_dequantizes_in_kernel_order():
    """level·(scale·gs), the Pallas kernel's order, within rounding of the
    oracle's (level·scale)·gs."""
    _, w = _operands(1, 64, 128, jnp.float32, 3)
    pk, sc, gs = (_t(a) for a in _quantize(w))
    wk = tmm.dequantize_kernel_order(pk, sc, gs)
    wo = tref.dequantize_ref(pk, sc, gs)
    torch.testing.assert_close(wk, wo, rtol=1e-6, atol=0)


@pytest.mark.parametrize("a4", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fp4_linear_matches_reference(a4, dtype):
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((64, 256)).astype(np.float32)) \
        .astype(DTYPES[dtype])
    w = jnp.asarray((rng.standard_normal((256, 128)) * 0.05)
                    .astype(np.float32)).astype(DTYPES[dtype])
    y_j = _linear(x, w, a4=a4)
    y_t = tops.fp4_linear(_t(x), _t(w), a4=a4)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dequantize_ref_bitwise(dtype):
    _, w = _operands(1, 48, 96, DTYPES[dtype], 9)
    pk, sc, gs = _quantize(w)
    ref = jax.jit(jref.dequantize_ref)(pk, sc, gs)
    _bits_equal(ref, tref.dequantize_ref(_t(pk), _t(sc), _t(gs)).numpy())


@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 32)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fp4_sim_values_bitwise(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32)) \
        .astype(DTYPES[dtype])
    ref = jax.jit(jquant.fp4_sim)(x)
    got = tquant.fp4_sim(_t(x))
    assert got.dtype == _t(x).dtype
    _bits_equal(np.asarray(ref, np.float32), to_numpy(got))


def test_fp4_sim_gradient_is_the_reference_one():
    """Straight-through: the gradient is the cotangent, as jax.grad's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    c = rng.standard_normal((4, 32)).astype(np.float32)
    g_j = jax.grad(lambda v: jnp.sum(jquant.fp4_sim(v) * c))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tquant.fp4_sim(xt) * torch.from_numpy(c)).sum().backward()
    _bits_equal(np.asarray(g_j), xt.grad.numpy())


@pytest.mark.parametrize("a4", [False, True])
def test_quantized_matmul_references(a4):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((32, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 96)) * 0.1).astype(np.float32)   # [K,N]
    qj = jax.jit(jquant.quantize_fp4)(jnp.asarray(w).T)
    qt = tquant.QTensor(*(_t(a) for a in qj))
    fj, ft = (jquant.matmul_w4a4, tquant.matmul_w4a4) if a4 \
        else (jquant.matmul_w4a16, tquant.matmul_w4a16)
    ref = jax.jit(fj)(jnp.asarray(x), qj)
    got = ft(torch.from_numpy(x), qt)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_quant_error_matches_reference(scale):
    rng = np.random.default_rng(int(scale * 100))
    w = (rng.standard_normal((64, 128)) * scale).astype(np.float32)
    ref = float(jax.jit(jquant.quant_error)(jnp.asarray(w)))
    got = float(tquant.quant_error(torch.from_numpy(w)))
    assert abs(got - ref) <= 1e-6, (got, ref)


# The CUDA kernel's arithmetic, emulated: per group of 16 along K an exact
# product of x's bf16 terms (or a4 levels) with W's E2M1 levels, rounded
# once to f32 (the tensor cores' sum), then promoted into an f32
# accumulator in group order, acc = fma(P, c, acc) (c = scale·gs, times
# the a4 scale s with a4).

def _split3(x32):
    """f32 x as three bf16-valued f32 terms, each the top 16 bits of what
    is left (truncation: never rounds up past the largest bf16)."""
    terms, rest = [], x32.astype(np.float32)
    for _ in range(3):
        t = (rest.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
        terms.append(t)
        rest = (rest - t).astype(np.float32)
    return terms


def _emulated_kernel(x, pk, sc, gs, a4):
    from repro_torch.kernels.nvfp4 import (INV_FP4_MAX, decode_level,
                                           fp4_index, fp4_level)
    x32 = np.asarray(x, np.float32)
    m, k = x32.shape
    g = k // 16
    lv = decode_level(tquant.unpack_u4(_t(pk))).numpy().astype(np.float64)
    cw = np.asarray(sc, np.float32) * np.float32(np.asarray(gs))   # [n, g]
    xg = x32.reshape(m, g, 16)
    if a4:
        amax = np.abs(xg).max(-1)
        s = np.maximum(amax * np.float32(INV_FP4_MAX), np.float32(1e-20))
        r = torch.from_numpy(xg / s[..., None])
        terms = [(torch.sign(r) * fp4_level(fp4_index(r.abs()))).numpy()]
    else:
        terms = [t.reshape(m, g, 16) for t in _split3(x32)]
    p = sum(np.einsum("mgk,ngk->mng", t.astype(np.float64),
                      lv.reshape(-1, g, 16)) for t in terms)
    p = p.astype(np.float32)
    acc = np.zeros(p.shape[:2], np.float32)
    for j in range(g):
        c = cw[None, :, j]
        if a4:
            c = (s[:, j, None] * c).astype(np.float32)
        acc = (acc.astype(np.float64)
               + p[:, :, j].astype(np.float64) * c.astype(np.float64)
               ).astype(np.float32)
    return acc


@pytest.mark.parametrize("m,n,k", SHAPES + ODD_SHAPES)
@pytest.mark.parametrize("a4", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_arithmetic_matches_pallas(m, n, k, a4, dtype):
    """The group-factored form (exact per-group products, f32 promotion)
    within the plain version's tolerance of the Pallas kernel."""
    x, w = _operands(m, n, k, DTYPES[dtype], m + n + k)
    pk, sc, gs = _quantize(w)
    y_pallas = _matmul(x, pk, sc, gs, a4=a4)
    y = _emulated_kernel(np.asarray(x, np.float32), pk, sc, gs, a4)
    np.testing.assert_allclose(y, np.asarray(y_pallas), rtol=1e-5,
                               atol=1e-4)


def test_truncation_split_is_exact():
    """x = b1 + b2 + b3 bit for bit, each term bf16-valued, for finite f32
    x with |x| ≥ 2^-100, 3.39e38, 3.4e38 and the largest f32 included (the
    last two above the midpoint between bf16's largest finite value and
    2^128, which round to nearest sends to inf)."""
    rng = np.random.default_rng(0)
    mant = rng.uniform(1.0, 2.0, 200_000)
    expo = rng.integers(-100, 128, mant.size)
    sign = rng.choice([-1.0, 1.0], mant.size)
    big = [3.39e38, -3.4e38, np.finfo(np.float32).max, 2.0 ** -100]
    x = np.concatenate([(sign * np.ldexp(mant, expo)).astype(np.float32),
                        np.asarray(big, np.float32)])
    x = x[np.isfinite(x)]
    terms = _split3(x)
    for t in terms:
        assert np.isfinite(t).all()
        assert not (t.view(np.uint32) & np.uint32(0xFFFF)).any()
    total = sum(t.astype(np.float64) for t in terms)
    assert np.array_equal(total, x.astype(np.float64))
    assert torch.isinf(torch.tensor(3.4e38).to(torch.bfloat16))

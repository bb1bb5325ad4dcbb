"""NVFP4 numerics of the port, bitwise against the jitted reference
(``repro.kernels.nvfp4`` and ``repro.core.quant``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels import nvfp4 as jnv
from repro_torch.convert import tensor_from_numpy, to_numpy
from repro_torch.core import quant as tquant
from repro_torch.kernels import nvfp4 as tnv


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    mism = int((a != b).sum())
    assert mism == 0, f"{mism} of {a.size} differ"


def _pow2_edges():
    """Every power of two in [2^-10, 448] and the f32 neighbours of each."""
    vals = []
    for k in range(-10, 9):
        p = np.float32(2.0 ** k)
        vals += [p, np.nextafter(p, np.float32(0)),
                 np.nextafter(p, np.float32(np.inf))]
    top = np.float32(448.0)
    vals += [top, np.nextafter(top, np.float32(0)),
             np.nextafter(top, np.float32(np.inf))]
    return np.asarray(vals, np.float32)


def test_reciprocal_trap_pinned():
    """XLA compiles the reference's ``amax / FP4_MAX`` into a multiply by
    the f32 reciprocal: true division differs from the jitted reference,
    the port's reciprocal multiply does not."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4096, 64)) * 3).astype(np.float32)
    ref = np.asarray(jax.jit(jnv.fake_quant_a4)(jnp.asarray(x)))
    _bits_equal(ref, tnv.fake_quant_a4(torch.from_numpy(x)).numpy())
    amax = np.abs(x.reshape(-1, 16)).max(-1)
    true_div = amax / np.float32(6.0)
    recip = amax * np.float32(tnv.INV_FP4_MAX)
    assert (true_div != recip).any()     # the trap is real on these inputs


def test_global_scale_reciprocal_trap():
    rng = np.random.default_rng(1)
    mism_true_div = 0
    for i in range(64):
        w = (rng.standard_normal((8, 64)) * rng.uniform(0.01, 10)).astype(
            np.float32)
        ref = np.asarray(jax.jit(jquant.global_scale_for)(jnp.asarray(w)))
        port = tquant.global_scale_for(torch.from_numpy(w)).numpy()
        _bits_equal(ref, port)
        mism_true_div += int(np.float32(np.abs(w).max())
                             / np.float32(6.0 * 448.0) != ref)
    assert mism_true_div > 0


def test_e4m3_round_pow2_edges_and_sweep():
    rng = np.random.default_rng(2)
    x = np.concatenate([_pow2_edges(), -_pow2_edges(),
                        rng.uniform(0, 500, 200_000).astype(np.float32),
                        np.float32([0.0, 1e-12, 600.0])])
    ref = np.asarray(jax.jit(jnv.e4m3_round)(jnp.asarray(x)))
    _bits_equal(ref, tnv.e4m3_round(torch.from_numpy(x)).numpy())


def test_fp4_code_level_decode_match():
    x = np.concatenate([np.linspace(-7, 7, 20_001, dtype=np.float32),
                        np.float32(list(jnv.FP4_MIDPOINTS)),
                        -np.float32(list(jnv.FP4_MIDPOINTS))])
    xt = torch.from_numpy(x)
    _bits_equal(jax.jit(jnv.fp4_code)(jnp.asarray(x)), tnv.fp4_code(xt))
    _bits_equal(jax.jit(jnv.fp4_round)(jnp.asarray(x)), tnv.fp4_round(xt))
    codes = np.arange(16, dtype=np.uint8)
    _bits_equal(jax.jit(jnv.decode_level)(jnp.asarray(codes)),
                tnv.decode_level(torch.from_numpy(codes)))


@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128)])
def test_fake_quant_a4_bitwise(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    x.reshape(-1)[:16] = 0.0                           # an all-zero group
    ref = np.asarray(jax.jit(jnv.fake_quant_a4)(jnp.asarray(x)))
    _bits_equal(ref, tnv.fake_quant_a4(torch.from_numpy(x)).numpy())


def test_pack_unpack_roundtrip_matches():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 16, (6, 64)).astype(np.uint8)
    packed = np.asarray(jax.jit(jquant.pack_u4)(jnp.asarray(codes)))
    tp = tquant.pack_u4(torch.from_numpy(codes))
    _bits_equal(packed, tp.numpy())
    _bits_equal(codes, tquant.unpack_u4(tp).numpy())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("scale", [0.07, 3.0])
def test_quantize_dequantize_bitwise(dtype, scale):
    rng = np.random.default_rng(4)
    w = jnp.asarray((rng.standard_normal((5, 48, 96)) * scale)
                    .astype(np.float32)).astype(dtype)
    wn = np.asarray(w)
    q = jax.jit(jquant.quantize_fp4)(w)
    qt = tquant.quantize_fp4(tensor_from_numpy(wn))
    _bits_equal(q.packed, qt.packed.numpy())
    _bits_equal(q.scales, qt.scales.numpy())
    _bits_equal(q.global_scale, qt.global_scale.numpy())
    dq = jax.jit(jquant.dequantize_fp4)(q)
    _bits_equal(dq, to_numpy(tquant.dequantize_fp4(qt)))


def test_quantize_pow2_edge_scales_bitwise():
    """Groups whose local scale lands on every power-of-two edge of the
    E4M3 grid (amax = 6 · edge with global scale 1)."""
    edges = _pow2_edges()
    rng = np.random.default_rng(5)
    w = rng.uniform(-1, 1, (edges.size, 16)).astype(np.float32)
    w *= (6.0 * edges)[:, None] / np.abs(w).max(-1, keepdims=True)
    w = w.reshape(-1, 32)                  # two groups per row
    gs = np.float32(1.0)
    q = jax.jit(lambda w: jquant.quantize_fp4(w, global_scale=gs))(
        jnp.asarray(w))
    qt = tquant.quantize_fp4(torch.from_numpy(w), global_scale=torch.tensor(gs))
    _bits_equal(q.packed, qt.packed.numpy())
    _bits_equal(q.scales, qt.scales.numpy())

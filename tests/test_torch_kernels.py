"""The port's two kernels: each plain version against the Pallas kernel in
interpret mode (quantize bitwise; grouped FFN at the reference's own kernel
tolerance).  The CUDA kernels against these plain versions are in
tests/test_torch_cuda.py, which runs on a card."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ReaLBConfig
from repro.core import quant as jquant
from repro.kernels import ops as jops
from repro_torch.convert import tensor_from_numpy, to_numpy
from repro_torch.core import quant as tquant
from repro_torch.kernels import grouped_fp4_ffn as tffn
from repro_torch.kernels import ops as tops

DTYPES = [jnp.float32, jnp.bfloat16]
# (m, d, f, gs) — the reference's GROUPED_CASES (tests/test_kernels.py):
# empty groups interleaved, one hot slot, first slot only, ragged m,
# cap-dropped rows in the trailing pad slot
GROUPED_CASES = [
    (24, 64, 64, [3, 0, 5, 0, 0, 9, 7, 0, 0]),
    (16, 64, 96, [0, 16, 0, 0, 0]),
    (40, 128, 64, [40, 0, 0]),
    (37, 64, 64, [10, 0, 12, 15]),
    (32, 64, 64, [6, 10, 0, 16]),
    (8, 32, 32, [1, 2, 0, 5]),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one worker per core, and these
    tiny tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype.kind == "f":
        a, b = a.view(np.uint32), b.view(np.uint32)
    assert int((a != b).sum()) == 0, f"{int((a != b).sum())} differ"


# jitted, as the engine runs it: eager JAX divides by the constant
# FP4_MAX * E4M3_MAX in global_scale_for, jitted XLA multiplies by its f32
# reciprocal, and the two global scales can differ by one ulp
_pallas_quantize = jax.jit(partial(jops.quantize_experts_fp4, interpret=True))


def _weights(seed, g, rows, cols, dtype):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((g, rows, cols)) * 0.3).astype(np.float32)
    return jnp.asarray(w).astype(dtype)


@pytest.mark.parametrize("g,n,k", [(5, 48, 96), (3, 17, 64), (2, 8, 512)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_plain_matches_pallas(g, n, k, dtype):
    w = _weights(g * n + k, g, n, k, dtype)
    ref = _pallas_quantize(w)
    q = tops.quantize_experts_fp4(tensor_from_numpy(np.asarray(w)))
    _bits_equal(ref.packed, q.packed.numpy())
    _bits_equal(ref.scales, q.scales.numpy())
    _bits_equal(ref.global_scale, q.global_scale.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_plain_strided_view(dtype):
    """The serving path quantizes w.transpose(-1, -2) of [E, D, F] without
    a copy; the result equals the reference on the transposed stack."""
    w = _weights(7, 4, 64, 48, dtype)                       # [E, D, F]
    ref = _pallas_quantize(jnp.swapaxes(w, -1, -2))
    q = tops.quantize_experts_fp4(
        tensor_from_numpy(np.asarray(w)).transpose(-1, -2))
    _bits_equal(ref.packed, q.packed.numpy())
    _bits_equal(ref.scales, q.scales.numpy())


def _quantized_experts(seed, n_groups, d, f, dtype):
    """Reference QTensors in the layout _quantize_experts produces."""
    out = {}
    for i, (name, (rows, cols)) in enumerate(
            dict(w_gate=(f, d), w_up=(f, d), w_down=(d, f)).items()):
        out[name] = jax.jit(jquant.quantize_fp4)(
            _weights(seed + i, n_groups, rows, cols, dtype))
    return out


def _to_port(wq):
    return {n: tquant.QTensor(*(tensor_from_numpy(np.asarray(a)) for a in q))
            for n, q in wq.items()}


def _check_ffn(y, ref, bf16):
    ya, ra = np.asarray(y, np.float32), np.asarray(ref, np.float32)
    assert ya.shape == ra.shape
    if bf16:
        # the reference's own bf16 tolerance (tests/test_kernels.py): the
        # h fake-quant is piecewise constant, so a bf16 rounding difference
        # near a level midpoint moves a whole FP4 level; pin the aggregate
        rel_l2 = np.linalg.norm(ya - ra) / max(np.linalg.norm(ra), 1e-9)
        assert rel_l2 < 3e-2, rel_l2
        peak = np.abs(ya - ra).max() / max(np.abs(ra).max(), 1e-9)
        assert peak < 0.1, peak
    else:
        np.testing.assert_allclose(ya, ra, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("m,d,f,gs", GROUPED_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_ffn_plain_matches_pallas(m, d, f, gs, dtype):
    gs_j = jnp.asarray(gs, jnp.int32)
    wq = _quantized_experts(m + d + f, len(gs), d, f, dtype)
    rng = np.random.default_rng(m * 3 + 1)
    xs = jnp.asarray(rng.standard_normal((m, d)).astype(np.float32)) \
        .astype(dtype)
    ref = jax.jit(partial(jops.grouped_fp4_ffn, group=ReaLBConfig().group_size,
                          act=jax.nn.silu, interpret=True))(xs, gs_j, wq)
    y = tops.grouped_fp4_ffn(tensor_from_numpy(np.asarray(xs)),
                             torch.tensor(gs, dtype=torch.int32), _to_port(wq))
    assert y.dtype == tensor_from_numpy(np.asarray(xs)).dtype
    _check_ffn(to_numpy(y), ref, dtype == jnp.bfloat16)


def test_grouped_matmul_rows_past_counts_are_zero():
    """ragged_dot semantics: rows beyond sum(gs) stay 0."""
    x = torch.ones(6, 32)
    w = torch.ones(2, 32, 8)
    y = tffn.grouped_matmul(x, w, torch.tensor([2, 1]))
    assert torch.all(y[:3] == 32) and torch.all(y[3:] == 0)

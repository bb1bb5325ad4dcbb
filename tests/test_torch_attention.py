"""The port's attention at any KV length against the reference's:
``scaled_attention`` (dense, q-blocked, chunked online softmax and the
decode flash path), the chunk-prefill ``_chunk_attention`` (dense at any
cache length) and ``gqa_forward``, on narrow heads (h 4, kh 2, d 16).

Tolerances: f32 within rtol 1e-5 / atol 1e-5.  bf16 outputs within one
bf16 ulp of the tensor's largest magnitude: both packages round the same
f32 products and sums, which differ only in summation order and in f32
``exp`` ulps.  ``p`` is rounded to bf16 before PV, so a ``p`` that lands on
the other side of a rounding midpoint moves its term ``p·v`` by 2^-8 of
itself: the error of an element is set by the size of the terms it sums
(up to the largest |v|), not by its own size, and the final rounding adds
one ulp of the element."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import attention as tattn

H, KH, D = 4, 2, 16
CASES = [(1, 2049), (8, 4096), (2048, 2048), (2050, 2050), (3072, 3072),
         (4096, 4096), (8192, 8192)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(s, t, dtype, seed, b=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, H, D)).astype(np.float32)
    k = rng.standard_normal((b, t, KH, D)).astype(np.float32)
    v = rng.standard_normal((b, t, KH, D)).astype(np.float32)
    jdt, _ = DTYPES[dtype]
    qj, kj, vj = (np.asarray(jnp.asarray(a, jdt)) for a in (q, k, v))
    return (qj, kj, vj), tuple(tensor_from_numpy(a, "cpu")
                               for a in (qj, kj, vj))


def _bf16_ulp(ref):
    """One bf16 ulp of the tensor's largest magnitude."""
    return 2.0 ** (np.floor(np.log2(max(float(np.abs(ref).max()), 1e-30)))
                   - 7)


def _check(out_t, out_j, dtype):
    out_j = np.asarray(jnp.asarray(out_j, jnp.float32))
    got = out_t.to(torch.float32).numpy()
    assert got.shape == out_j.shape
    assert np.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, out_j, rtol=1e-5, atol=1e-5)
    else:
        bad = np.abs(got - out_j) > _bf16_ulp(out_j)
        assert not bad.any(), (int(bad.sum()), float(
            np.abs(got - out_j).max()))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("masked", [False, True], ids=["all", "kv_valid"])
@pytest.mark.parametrize("s,t", CASES, ids=[f"{s}x{t}" for s, t in CASES])
def test_scaled_attention_matches_reference(s, t, masked, dtype):
    """Decode shapes (s <= 8) run non-causal as decode calls them; s == t
    runs causal self-attention (the q-blocked and chunked branches)."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(s, t, dtype, seed=s + t)
    causal = s == t
    kv_valid = np.array([t, t - 7 if causal else t // 3 + 1], np.int32) \
        if masked else None
    scale = D ** -0.5
    ref = jax.jit(partial(jattn.scaled_attention, scale=scale,
                          causal=causal))(
        qj, kj, vj, kv_valid=None if kv_valid is None
        else jnp.asarray(kv_valid))
    got = tattn.scaled_attention(
        qt, kt, vt, scale, causal=causal,
        kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid))
    _check(got, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s,t", [(8, 4096), (64, 3000), (16, 8192)],
                         ids=["8x4096", "64x3000", "16x8192"])
def test_chunk_attention_dense_at_any_length(s, t, dtype):
    """Chunk-prefill attention against a cache longer than 2048: per-row
    causal masks at each row's own positions, no length limit."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(s, t, dtype, seed=7 * s + t)
    start = np.array([t - s, t // 2], np.int32)
    q_pos = (start[:, None] + np.arange(s)[None, :]).astype(np.int32)
    ref = jax.jit(jattn._chunk_attention, static_argnums=3)(
        qj, kj, vj, D ** -0.5, jnp.asarray(q_pos))
    got = tattn._chunk_attention(qt, kt, vt, D ** -0.5,
                                 torch.from_numpy(q_pos))
    _check(got, ref, dtype)


@pytest.mark.parametrize("s", [64, 2050, 4096])
def test_gqa_forward_matches_reference(s):
    """Full self-attention of reduced moonshot (f32) at short and long
    sequence lengths: the output and the unpadded K/V it returns."""
    cfg_j = jreduced(jget("moonshot-v1-16b-a3b"))
    cfg_t = reduced(get_config("moonshot-v1-16b-a3b"))
    rng = np.random.default_rng(s)
    d, h, kh, hd = cfg_j.d_model, cfg_j.n_heads, cfg_j.n_kv_heads, \
        cfg_j.head_dim
    p = {"wq": rng.standard_normal((d, h, hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, kh, hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, kh, hd)) / np.sqrt(d),
         "wo": rng.standard_normal((h, hd, d)) / np.sqrt(h * hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((1, s, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    out_j, kv_j = jax.jit(partial(jattn.gqa_forward, cfg=cfg_j))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        positions=jnp.asarray(pos))
    out_t, kv_t = tattn.gqa_forward(params_from_numpy(p, "cpu"),
                                    torch.from_numpy(x), cfg_t,
                                    positions=torch.from_numpy(pos))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)
    for n in ("k", "v"):
        assert tuple(kv_t[n].shape) == (1, s, kh, hd)
        np.testing.assert_allclose(kv_t[n].numpy(), np.asarray(kv_j[n]),
                                   rtol=1e-5, atol=1e-5)

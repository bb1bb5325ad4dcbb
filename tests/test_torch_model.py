"""The port's model stack against the reference on reduced moonshot (4
layers, d 128, 8 experts top-2, f32): ``chunk_forward`` then
``decode_forward`` against the jitted JAX forwards, with the weights passed
through ``repro_torch.convert``."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import get_config, reduced
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf

ARCH = "moonshot-v1-16b-a3b"
B, S, L, VEP = 4, 16, 64, 4
# f32 through 4 layers: XLA's and torch's cos/sin/pow/rsqrt differ by an
# ulp (rope_freqs alone differs in 2 of 16 entries) and matmuls sum in
# another order; the residual stream (|x| up to ~24 with these random
# weights) carries those differences into every projection.  The error of
# an element therefore scales with the tensor's largest value, not its
# own: measured up to 1.5e-5 x max|ref| on the KV cache.
RTOL, ATOL_REL = 1e-4, 3e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one worker per core, and these
    tiny tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jreduced(jget(ARCH)), reduced(get_config(ARCH))
    params = jtf.init_model(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def test_config_copy_matches_reference():
    """The port's config copy equals the reference field for field."""
    for full in (False, True):
        cj, ct = jget(ARCH), get_config(ARCH)
        if not full:
            cj, ct = jreduced(cj), reduced(ct)
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name) or (
                f.name == "moe" and dataclasses.asdict(ct.moe)
                == dataclasses.asdict(cj.moe)), f.name
        assert ct.ffn_kinds() == cj.ffn_kinds()
    assert dataclasses.asdict(TCfg()) == dataclasses.asdict(JCfg())


def test_norm_and_rope_match(model):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         1e-6).numpy(),
        np.asarray(jax.jit(jcommon.rms_norm, static_argnums=2)(
            x, scale, 1e-6)), rtol=1e-6, atol=1e-6)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5) * 7
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           50000.0).numpy(),
        np.asarray(jax.jit(jcommon.apply_rope, static_argnums=2)(
            x, pos, 50000.0)), rtol=1e-5, atol=1e-5)


def _compare(j, t, what):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, err_msg=what, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(j).max()))


POLICIES = {"fp4": dict(gate_gamma=8, md_init=0.0, adaptive=False),
            "bf16": dict(gate_gamma=10 ** 9, md_init=0.5),
            "aimd": dict(gate_gamma=16, md_init=0.5)}


@pytest.mark.parametrize("policy", list(POLICIES))
def test_chunk_then_decode_match_reference(model, policy):
    cfg_j, cfg_t, params, tparams = model
    kw = POLICIES[policy]
    jr, tr = JCfg(**kw), TCfg(**kw)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens,
             "start": np.array([0, 3, 0, 0], np.int32),
             "chunk_len": np.array([16, 10, 0, 5], np.int32),
             "modality": rng.random((B, S)) < 0.6}
    cache_j = jtf.init_cache(cfg_j, B, L)
    m = np.full((1, VEP), kw["md_init"], np.float32)

    chunk = jax.jit(partial(jtf.chunk_forward, cfg=cfg_j, rcfg=jr))
    res_j = chunk(params, batch=jax.tree.map(jnp.asarray, batch),
                  cache=cache_j, m_state=jnp.asarray(m))
    tcache = cache_from_numpy(jax.tree.map(np.asarray, cache_j), "cpu")
    res_t = ttf.chunk_forward(tparams, cfg_t, tr,
                              {k: torch.from_numpy(v) for k, v in
                               batch.items()}, tcache, torch.from_numpy(m))
    if policy != "aimd":
        assert (float(res_t.aux["fp4_ranks"]) > 0) == (policy == "fp4")
    _compare(res_j.logits, res_t.logits, "chunk logits")
    assert np.array_equal(np.asarray(res_j.m_state), res_t.m_state.numpy())
    for k in ("moe_stats", "expert_stats", "slot_stats"):
        assert np.array_equal(np.asarray(res_j.aux[k]),
                              res_t.aux[k].numpy()), k
    for group in ("prefix", "blocks"):
        for layer, kv in res_j.cache[group].items():
            for n in ("k", "v"):
                _compare(kv[n], res_t.cache[group][layer][n],
                         f"{group}/{layer}/{n} after chunk")

    # decode: one ready slot per row except row 2, whose pos = L drops
    dec = {"tokens": tokens[:, :1],
           "pos": np.array([16, 13, L, 5], np.int32),
           "modality": np.array([[True], [False], [False], [True]]),
           "valid": np.array([[True], [True], [False], [True]])}
    decode = jax.jit(partial(jtf.decode_forward, cfg=cfg_j, rcfg=jr))
    dj = decode(params, batch=jax.tree.map(jnp.asarray, dec),
                cache=res_j.cache, m_state=res_j.m_state)
    dt = ttf.decode_forward(tparams, cfg_t, tr,
                            {k: torch.from_numpy(v) for k, v in dec.items()},
                            res_t.cache, res_t.m_state)
    _compare(dj.logits, dt.logits, "decode logits")
    assert np.array_equal(np.asarray(dj.m_state), dt.m_state.numpy())
    assert np.array_equal(np.asarray(dj.aux["moe_stats"]),
                          dt.aux["moe_stats"].numpy())
    for group in ("prefix", "blocks"):
        for layer, kv in dj.cache[group].items():
            for n in ("k", "v"):
                _compare(kv[n], dt.cache[group][layer][n],
                         f"{group}/{layer}/{n} after decode")


def test_init_model_layout_and_seed():
    """The port's init: the reference's key paths and shapes, zero norms,
    the embed std, and a seed that fixes every value."""
    cfg = reduced(get_config(ARCH))
    ref = jax.eval_shape(lambda: jtf.init_model(jreduced(jget(ARCH)),
                                                jax.random.PRNGKey(0)))
    p1 = ttf.init_model(cfg, seed=3, device="cpu")
    p2 = ttf.init_model(cfg, seed=3, device="cpu")

    def walk(r, a, b, path=""):
        if isinstance(r, dict):
            assert set(r) == set(a), path
            for k in r:
                walk(r[k], a[k], b[k], f"{path}/{k}")
            return
        assert tuple(a.shape) == tuple(r.shape), path
        assert torch.equal(a, b), path
    walk(ref, p1, p2)
    assert torch.all(p1["final_norm"] == 0)
    assert abs(float(p1["embed"].std()) - 0.02) < 2e-3

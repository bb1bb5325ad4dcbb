"""Multi-head latent attention and minicpm3-4b in the port against the
reference on the CPU (helpers and the spread tolerance in
``_torch_arch.py``).

* ``MLAConfig``, the ``mla`` field, MLA's parameter count and ``reduced``'s
  MLA term equal the reference's; ``mla_spec`` and the latent cache
  (``latent [B, L, kv_lora_rank]``, ``k_rope [B, L, qk_rope_head_dim]``,
  the parameter dtype) have its shapes.
* ``scaled_attention`` with a value width other than the q/k width
  (minicpm3: 64 against 96) on its three branches, past 2048 keys.
* ``mla_forward`` at 2304 keys (the q-blocked chunked branch) and its
  gradient; ``mla_decode``'s absorbed path in f32 and in bf16 (f32 scores
  of bf16 products, the context rounded before ``W_vb``), its rows written
  into the cache in place, a write at ``pos >= L`` dropped.
* Reduced minicpm3: ``prefill_forward`` plus two ``decode_forward``s, and
  ``train_loss``'s gradient, within the spread; the reference's smoke and
  prefill/decode consistency; its ``Engine`` (one-shot prefill: the latent
  cache is not continued mid-prompt) against the reference's.
* minicpm3 at its published widths cut to 2 layers, where the card holds
  its f32 decode/prefill gap: the reference's spread far inside the
  bound, the port's gap within it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch as ta
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS, MLAConfig, get_config, reduced
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.convert import to_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf

ARCH = "minicpm3-4b"
TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return ta.Model(ARCH)


def _close(j, t, what, tol=TOL):
    j = np.asarray(j, np.float32)
    t = to_numpy(t).astype(np.float32)
    err = float(np.abs(t - j).max())
    assert err <= tol * float(np.abs(j).max()), (what, err)


def test_config_and_counts_are_the_reference_copy():
    cfg_t, cfg_j = get_config(ARCH), jget(ARCH)
    assert ARCH in ARCH_IDS and len(ARCH_IDS) == 10
    ft, fj = dataclasses.asdict(cfg_t), dataclasses.asdict(cfg_j)
    for k, v in ft.items():
        assert fj[k] == v, k
    assert dataclasses.asdict(MLAConfig()) == dataclasses.asdict(
        type(cfg_j.mla)())
    for c_t, c_j in ((cfg_t, cfg_j), (reduced(cfg_t), jreduced(cfg_j))):
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
    assert reduced(cfg_t).mla == MLAConfig(64, 32, 16, 8, 16)
    # the MLA term counts: a GQA layer of the same heads counts otherwise
    gqa = dataclasses.replace(cfg_t, mla=None)
    assert gqa.param_count() != cfg_t.param_count()


def test_param_counts_match_declared():
    cfg = get_config(ARCH)
    _, n_blocks, _ = ttf.block_structure(cfg)
    got = ta.spec_param_count(ttf.model_spec(cfg), n_blocks)
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(jtf.abstract_model(jget(ARCH))))
    assert got == want
    assert abs(got - cfg.param_count()) / cfg.param_count() < 0.03


def test_spec_and_latent_cache_layout(model):
    spec_j = jattn.attn_spec(model.cfg_j)
    spec_t = tattn.attn_spec(model.cfg_t)
    assert {k: tuple(p.shape) for k, p in spec_t.items()} == \
        {k: tuple(p.shape) for k, p in spec_j.items()}
    assert {k: p.init for k, p in spec_t.items()} == \
        {k: p.init for k, p in spec_j.items()}
    for dtype in ("float32", "bfloat16"):
        cfg_j = dataclasses.replace(model.cfg_j, param_dtype=dtype)
        cfg_t = dataclasses.replace(model.cfg_t, param_dtype=dtype)
        want = ta.flat(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype)
                                    if dtype == "float32" else
                                    np.zeros(a.shape, np.float32),
                                    jtf.abstract_cache(cfg_j, 2, 9)))
        got = ttf.init_cache(cfg_t, 2, 9, "cpu")
        assert {k: v.shape for k, v in want.items()} == \
            {k: tuple(v.shape) for k, v in ta.flat(got).items()}
        layer = got["blocks"]["layer0"]
        assert set(layer) == {"latent", "k_rope"}
        assert all(str(t.dtype) == f"torch.{dtype}" for t in layer.values())


@pytest.mark.parametrize("s,t", [(3, 2304), (300, 2304), (2304, 2304),
                                 (16, 40)])
def test_value_width_differs_from_qk_width(s, t):
    """q/k 96 wide, v 64 (minicpm3's heads): decode flash (s <= 8 past
    2048 keys), chunked and q-blocked prefill, and the dense branch."""
    rng = np.random.default_rng(s + t)
    q = rng.normal(0, 1, (1, s, 2, 96)).astype(np.float32)
    k = rng.normal(0, 1, (1, t, 2, 96)).astype(np.float32)
    v = rng.normal(0, 1, (1, t, 2, 64)).astype(np.float32)
    causal = s == t
    valid = None if causal else np.array([t - 5], np.int32)
    want = jattn.scaled_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 96 ** -0.5,
        causal=causal, kv_valid=None if causal else jnp.asarray(valid))
    got = tattn.scaled_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        96 ** -0.5, causal=causal,
        kv_valid=None if causal else torch.from_numpy(valid))
    assert tuple(got.shape) == (1, s, 2, 64)
    _close(want, got, "attention")


def _layer_params(cfg_j, seed, dtype=np.float32):
    spec = jattn.mla_spec(cfg_j)
    rng = np.random.default_rng(seed)
    out = {}
    for k, p in spec.items():
        std = 0.3 if p.init != "zeros" else 0.2
        out[k] = rng.normal(0, std, p.shape).astype(dtype)
    return out


def _small_cfgs(**kw):
    over = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, **kw)
    return jreduced(jget(ARCH), **over), reduced(get_config(ARCH), **over)


def test_mla_forward_past_2048_keys_and_its_gradient():
    """``mla_forward`` at 2304 keys (q blocks, the second chunked) against
    the reference's: the output, latent and k_rope, and the gradient of
    every weight and of x."""
    cfg_j, cfg_t = _small_cfgs()
    p = _layer_params(cfg_j, 0)
    s = 2304
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (1, s, 64)).astype(np.float32)
    w = rng.normal(0, 1, (1, s, 64)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]

    def loss_j(p, x):
        o, kv = jattn.mla_forward(p, x, cfg_j, positions=pos)
        return jnp.sum(o * w), (o, kv)

    (_, (o_j, kv_j)), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(p, x)
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    o_t, kv_t = tattn.mla_forward(pt, xt, cfg_t,
                                  positions=torch.from_numpy(pos))
    (o_t * torch.from_numpy(w)).sum().backward()
    _close(o_j, o_t, "out")
    for n in ("latent", "k_rope"):
        _close(kv_j[n], kv_t[n], n)
    _close(gx_j, xt.grad, "dx", tol=1e-4)
    for k in p:
        _close(gp_j[k], pt[k].grad, f"d{k}", tol=1e-4)


@pytest.mark.parametrize("cache_len", [24, 2304])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_decode_absorbed_matches_reference(cache_len, dtype):
    """The absorbed decode on a filled cache (rows at and past ``pos`` of
    row 2 garbage, masked): the output and the new cache rows.  f32: within
    5e-5 of max of the reference's.  bf16 (f32 scores of bf16 products, the
    context rounded before ``W_vb``; XLA's CPU runtime cannot run the
    reference's bf16 x bf16 -> f32 dots): within four bf16 steps of max of
    the reference's f32 decode on the same bf16 values.  The rows land in
    the given cache tensors in place; row 1's write at ``pos = L`` is
    dropped."""
    cfg_j, cfg_t = _small_cfgs(param_dtype=dtype)
    cfg_j = dataclasses.replace(cfg_j, param_dtype="float32")
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p = _layer_params(cfg_j, 2)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (3, 1, 64)).astype(np.float32)
    cache = {"latent": rng.normal(0, 1, (3, cache_len, 32)),
             "k_rope": rng.normal(0, 1, (3, cache_len, 8))}
    pos = np.array([cache_len - 1, cache_len, 5], np.int32)

    def as_t(a):      # the values the port holds, in its dtype
        return torch.from_numpy(np.asarray(a, np.float32)).to(tdt)

    pt = {k: as_t(v) for k, v in p.items()}
    ct = {k: as_t(v) for k, v in cache.items()}
    xt = as_t(x)
    o_j, c_j = jax.jit(lambda p, x, c, pos: jattn.mla_decode(
        p, x, c, cfg_j, pos=pos))(
            {k: jnp.asarray(v.float().numpy()) for k, v in pt.items()},
            jnp.asarray(xt.float().numpy()),
            {k: jnp.asarray(v.float().numpy()) for k, v in ct.items()},
            jnp.asarray(pos))
    before = {k: v.clone() for k, v in ct.items()}
    ptrs = {k: v.data_ptr() for k, v in ct.items()}
    o_t, c_t = tattn.mla_decode(pt, xt, ct, cfg_t,
                                pos=torch.from_numpy(pos))
    assert o_t.dtype == tdt
    tol = TOL if dtype == "float32" else 2.0 ** -6
    _close(o_j, o_t.float(), "out", tol)
    for n in ("latent", "k_rope"):
        assert c_t[n].data_ptr() == ptrs[n]            # written in place
        _close(c_j[n], c_t[n].float(), n, tol)
        assert torch.equal(c_t[n][1], before[n][1])    # pos = L dropped
        changed = (c_t[n] != before[n]).any(dim=-1)
        assert changed.sum() == 2 and changed[0, -1] and changed[2, 5]


def test_prefill_then_decode_match_reference(model):
    ta.prefill_then_decode(model, dict(gate_gamma=4),
                           np.random.default_rng(1))


def test_train_grads_match_reference(model):
    assert ta.train_grads_match(model, dict(gate_gamma=4),
                                np.random.default_rng(3)) <= 1.0


def test_arch_smoke(model):
    ta.smoke(model, np.random.default_rng(0))


def test_prefill_decode_consistency(model):
    ta.consistency(model, np.random.default_rng(2))


def test_chunked_prefill_refuses_mla(model):
    cfg, rcfg = model.cfg_t, TCfg()
    cache = ttf.init_cache(cfg, 1, 8, "cpu")
    with pytest.raises(ValueError, match="GQA"):
        ttf.chunk_forward(model.tparams, cfg, rcfg, {
            "tokens": torch.zeros((1, 4), dtype=torch.int32),
            "start": torch.zeros(1, dtype=torch.int32),
            "chunk_len": torch.full((1,), 4, dtype=torch.int32)},
            cache, torch.zeros((1, 1)))


def test_engine_matches_reference(model):
    """One-shot prefill (``chunked`` False, as the reference's) and
    absorbed decode: the same tokens, times and IterStats."""
    eng = ta.engines_agree(model, dict(gate_gamma=8, md_init=0.0))
    assert not eng.chunked


def test_card_consistency_depth_is_not_chaotic():
    """minicpm3-4b at its published widths cut to the 2 layers on which
    ``chip_smoke.consistency_f32`` holds the f32 decode/prefill gap (vocab
    cut to 8192): the reference's own spread stays under a tenth of its
    bound, and the port's gap (absorbed decode) within the bound."""
    ta.card_check_is_not_chaotic("minicpm3-4b", 2,
                                 np.random.default_rng(17))

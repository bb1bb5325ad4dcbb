"""The port against the reference on 40- and 64-token prompts (reduced
moonshot, f32), with a margin-aware comparison of the routing.

The f32 gap between the two packages grows with depth, and it does so in
the reference too: fed the port's input to a layer, the reference's own
layer moves its output as far as the port's does
(``test_layer_gap_is_amplified_in_the_reference_too``).  Each
attention+MoE layer amplifies an input gap 2-7x (scores reach ~150, a
sharp softmax), and a layer whose FP4 branch fires can amplify it ~150x,
because the W4A4 expert FFN rounds its activations to E2M1 levels: an
input one ulp away can land on the next level.  Given the same input,
every layer of the port stays within 6.1e-6 of the reference's.

So the comparison is margin-aware.  A routing choice must be equal
wherever the reference's top-k margin (k-th minus (k+1)-th router logit)
exceeds ``MARGIN``; routing stats and ``m_state`` must be equal on every
case where no choice lies under it; logits are held at the tolerance of
their prompt length.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core import ep_moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import get_config, reduced
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.core import ep_moe as tmoe
from repro_torch.models import transformer as ttf

ARCH = "moonshot-v1-16b-a3b"
VEP = 4
# A choice flips only if two router logits move apart by more than their
# margin between the packages.  Each case holds the router logits' gap
# under GAP (measured: 40 tokens up to 5.3e-4; 64 tokens 8.3e-4 in BF16 and
# 3.5e-2 once an FP4 layer fed the router), so a choice whose margin
# exceeds 2 * GAP cannot flip, and must be equal.
GAP = {(40, "bf16"): 1e-3, (40, "fp4"): 1e-3,
       (64, "bf16"): 2e-3, (64, "fp4"): 0.1}
# logits: rtol 1e-4 and an absolute tolerance relative to max|ref|
# (measured: 40 tokens up to 6.0e-5; 64 tokens 5.4e-5 in BF16, 5.3e-4 with
# FP4 firing)
LOGIT_ATOL_REL = {(40, "bf16"): 2e-4, (40, "fp4"): 2e-4,
                  (64, "bf16"): 2e-4, (64, "fp4"): 2e-3}
# one layer of the port against the reference's on the same input
# (measured up to 6.1e-6 of max|ref| on these prompts)
LOCAL = 1e-5
POLICIES = {"fp4": dict(gate_gamma=8, md_init=0.0, adaptive=False),
            "bf16": dict(gate_gamma=10 ** 9, md_init=0.5)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _capture_routes(monkeypatch):
    """Record (eidx, logits) of every router call in both packages, in
    call order (one call per MoE layer)."""
    got_j, got_t = [], []
    orig_j, orig_t = jmoe._route, tmoe._route

    def route_j(router_w, x_t, e_cfg):
        gates, eidx, probs = orig_j(router_w, x_t, e_cfg)
        logits = x_t.astype(jnp.float32) @ router_w.astype(jnp.float32)
        jax.debug.callback(lambda e, l: got_j.append((np.asarray(e),
                                                      np.asarray(l))),
                           eidx, logits, ordered=True)
        return gates, eidx, probs

    def route_t(router_w, x_t, e_cfg):
        gates, eidx, probs = orig_t(router_w, x_t, e_cfg)
        logits = x_t.to(torch.float32) @ router_w.to(torch.float32)
        got_t.append((eidx.numpy(), logits.numpy()))
        return gates, eidx, probs

    monkeypatch.setattr(jmoe, "_route", route_j)
    monkeypatch.setattr(tmoe, "_route", route_t)
    return got_j, got_t


def _batch(cfg, n_tok, mode):
    rng = np.random.default_rng(n_tok)
    if mode == "prefill":
        return {"tokens": rng.integers(0, cfg.vocab_size, (1, n_tok))
                .astype(np.int32),
                "modality": rng.random((1, n_tok)) < 0.5}
    return {"tokens": rng.integers(0, cfg.vocab_size, (2, n_tok))
            .astype(np.int32),
            "start": np.zeros(2, np.int32),
            "chunk_len": np.array([n_tok, n_tok - 7], np.int32),
            "modality": rng.random((2, n_tok)) < 0.5}


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("mode", ["prefill", "chunk"])
@pytest.mark.parametrize("n_tok", [40, 64])
def test_long_prompt_margin_aware(model, monkeypatch, n_tok, mode, policy):
    cfg_j, cfg_t, params, tparams = model
    kw = POLICIES[policy]
    jr, tr = JCfg(**kw), TCfg(**kw)
    batch = _batch(cfg_j, n_tok, mode)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    m = np.full((1, VEP), kw["md_init"], np.float32)
    got_j, got_t = _capture_routes(monkeypatch)
    if mode == "prefill":
        fwd = jax.jit(partial(jtf.prefill_forward, cfg=cfg_j, rcfg=jr))
        res_j = fwd(params, batch=jax.tree.map(jnp.asarray, batch),
                    m_state=jnp.asarray(m))
        res_t = ttf.prefill_forward(tparams, cfg_t, tr, tbatch,
                                    torch.from_numpy(m))
    else:
        cache = jtf.init_cache(cfg_j, 2, 2 * n_tok)
        fwd = jax.jit(partial(jtf.chunk_forward, cfg=cfg_j, rcfg=jr))
        res_j = fwd(params, batch=jax.tree.map(jnp.asarray, batch),
                    cache=cache, m_state=jnp.asarray(m))
        res_t = ttf.chunk_forward(
            tparams, cfg_t, tr, tbatch,
            cache_from_numpy(jax.tree.map(np.asarray, cache), "cpu"),
            torch.from_numpy(m))
    jax.effects_barrier()
    n_moe = sum(f == "moe" for f in cfg_t.ffn_kinds())
    assert len(got_j) == len(got_t) == n_moe
    k = cfg_t.moe.top_k
    gap, same_routes = GAP[(n_tok, policy)], True
    for (ej, lj), (et, lt) in zip(got_j, got_t):
        assert np.abs(lt - lj).max() < gap
        srt = np.sort(lj, axis=-1)[:, ::-1]
        sure = srt[:, k - 1] - srt[:, k] > 2 * gap
        assert np.array_equal(ej[sure], et[sure])
        same_routes &= np.array_equal(ej, et)
    if same_routes:
        assert np.array_equal(np.asarray(res_j.m_state),
                              res_t.m_state.numpy())
        for key in ("moe_stats", "expert_stats", "slot_stats"):
            assert np.array_equal(np.asarray(res_j.aux[key]),
                                  res_t.aux[key].numpy()), key
    lj = np.asarray(res_j.logits)
    np.testing.assert_allclose(
        res_t.logits.numpy(), lj, rtol=1e-4,
        atol=LOGIT_ATOL_REL[(n_tok, policy)] * float(np.abs(lj).max()))


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("n_tok", [40, 64])
def test_layer_gap_is_amplified_in_the_reference_too(model, n_tok, policy):
    """Layer by layer through ``prefill_forward``'s stack: fed the same
    input, the port's layer stays within LOCAL of the reference's; fed the
    port's input, the reference's own layer moves its output as far as the
    port's gap (within 10 %), so the growth is the function's, not the
    port's rounding.  Prints each layer's gaps (relative to max|ref|)."""
    cfg_j, cfg_t, params, tparams = model
    kw = POLICIES[policy]
    jr, tr = JCfg(**kw), TCfg(**kw)
    batch = _batch(cfg_j, n_tok, "prefill")
    tok, mod = batch["tokens"], batch["modality"]
    pos = np.broadcast_to(np.arange(n_tok)[None], tok.shape).copy()

    def ref_layer(lp, x, m, ffn):
        return jax.jit(lambda lp, x, m: jtf.apply_layer(
            lp, x, cfg_j, jr, "attn", ffn, mode="prefill",
            positions=jnp.asarray(pos), pos=None, memory=None,
            cache_in=None, m_state=m, modality=jnp.asarray(mod),
            cache_len=n_tok, fsdp=False))(lp, x, m)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / np.abs(b).max())

    _, n_blocks, n_prefix = jtf.block_structure(cfg_j)
    layers = [(params["prefix"][str(i)], tparams["prefix"][str(i)], "dense")
              for i in range(n_prefix)] + [
        (jax.tree.map(lambda a, b=b: a[b], params["blocks"]["layer0"]),
         ttf._index(tparams["blocks"]["layer0"], b), "moe")
        for b in range(n_blocks)]
    xj = jtf._embed(params, cfg_j, jnp.asarray(tok), None, "prefill")
    xt = ttf._embed(tparams, cfg_t, torch.from_numpy(tok), None, "prefill")
    m = np.full((1, VEP), kw["md_init"], np.float32)
    mj, mt = jnp.asarray(m), torch.from_numpy(m)
    for i, (lj, lt, ffn) in enumerate(layers):
        want = ref_layer(lj, xj, mj, ffn)
        local = ttf.apply_layer(lt, torch.from_numpy(np.array(xj)), cfg_t,
                                tr, ffn, mode="prefill",
                                positions=torch.from_numpy(pos), pos=None,
                                cache_in=None, m_state=torch.from_numpy(
                                    np.array(mj)),
                                modality=torch.from_numpy(mod),
                                cache_len=n_tok)
        moved = ref_layer(lj, jnp.asarray(xt.numpy().copy()), mj, ffn)
        got = ttf.apply_layer(lt, xt, cfg_t, tr, ffn, mode="prefill",
                              positions=torch.from_numpy(pos), pos=None,
                              cache_in=None, m_state=mt,
                              modality=torch.from_numpy(mod),
                              cache_len=n_tok)
        g_in, g_local = rel(xt.numpy(), xj), rel(local[0].numpy(), want[0])
        g_ref, g_port = rel(moved[0], want[0]), rel(got[0].numpy(), want[0])
        print(f"{n_tok} tokens {policy} layer {i} ({ffn}): input gap "
              f"{g_in:.3g}, same-input gap {g_local:.3g}, reference on the "
              f"port's input {g_ref:.3g}, port {g_port:.3g}, FP4 ranks "
              f"{float(want[3]['fp4_ranks']):.0f}")
        assert g_local < LOCAL
        if i > 0:
            assert abs(g_port - g_ref) <= 0.1 * max(g_port, g_ref)
        xj, mj, xt, mt = want[0], want[2], got[0], got[2]

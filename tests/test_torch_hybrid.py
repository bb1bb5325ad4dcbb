"""The port's Mamba and hybrid stacks against the reference on the CPU:
reduced falcon-mamba-7b (8 Mamba layers, no FFN) and reduced
jamba-1.5-large-398b (one 8-layer block: attention then 7 Mamba layers,
MoE on the odd layers, 8 experts top-2), f32, weights carried across by
``repro_torch.convert``.

``prefill_forward`` then ``decode_forward`` (with an idle row) against the
jitted JAX forwards: logits and caches within 5e-5 of the reference's
largest value, jamba's routing statistics and ``m_state`` exact; the
reference's own prefill/decode consistency; and the port's ``Engine``
against the reference's on one seeded MMMU stream of 16-token prompts
(the one-shot prefill, as the reference takes for an SSM stack): the same
tokens, IterStats and ``m_state``, with FP4 firing in jamba's prefills."""
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
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JEngine
from repro.workloads import (ArrivalConfig, IterationCostModel, VirtualClock,
                             arrival_times, make_stream, profile)
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.workloads import arrivals as t_arrivals
from repro_torch.workloads import multimodal as t_multimodal

ARCHS = ("falcon-mamba-7b", "jamba-1.5-large-398b")
B, S, L, VEP = 3, 12, 24, 4
TOL = 5e-5                     # of max |reference|
POLICIES = {"fp4": dict(gate_gamma=8, md_init=0.0, adaptive=False),
            "bf16": dict(gate_gamma=10 ** 9, md_init=0.5)}
ENGINE = dict(max_slots=4, max_len=40, prefill_budget=16, virtual_ep=4)
ENGINE_POLICY = dict(gate_gamma=8, md_init=0.0)
N_REQ, MAX_PROMPT = 5, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The reduced model of each arch, built on first use: (arch, cfg_j,
    cfg_t, reference params, port params)."""
    built = {}

    def get(arch):
        if arch not in built:
            cfg_j, cfg_t = jreduced(jget(arch)), reduced(get_config(arch))
            params = jtf.init_model(cfg_j, jax.random.PRNGKey(0))
            built[arch] = (arch, cfg_j, cfg_t, params, params_from_numpy(
                jax.tree.map(np.asarray, params), "cpu"))
        return built[arch]
    return get


def _compare(j, t, what):
    j = np.asarray(j)
    err = np.abs(to_numpy(t) - j).max()
    assert err <= TOL * float(np.abs(j).max()), (what, err,
                                                  float(np.abs(j).max()))


def _compare_cache(cj, ct, what):
    for group, layers in cj.items():
        for layer, entries in layers.items():
            assert set(entries) == set(ct[group][layer])
            for n, v in entries.items():
                _compare(v, ct[group][layer][n], f"{what} {group}/{layer}/{n}")


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.mark.parametrize("arch,policy", [
    ("falcon-mamba-7b", "fp4"),        # no MoE layer: one policy covers it
    ("jamba-1.5-large-398b", "fp4"), ("jamba-1.5-large-398b", "bf16")])
def test_prefill_then_decode_match_reference(models, arch, policy):
    arch, cfg_j, cfg_t, params, tparams = models(arch)
    kw = POLICIES[policy]
    jr, tr = JCfg(**kw), TCfg(**kw)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_j.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "modality": rng.random((B, S)) < 0.6}
    m = np.full((1, VEP), kw["md_init"], np.float32)

    pre = jax.jit(partial(jtf.prefill_forward, cfg=cfg_j, rcfg=jr,
                          cache_len=L))
    rj = pre(params, batch=jax.tree.map(jnp.asarray, batch),
             m_state=jnp.asarray(m))
    rt = ttf.prefill_forward(tparams, cfg_t, tr, _torch(batch),
                             torch.from_numpy(m), cache_len=L)
    _compare(rj.logits, rt.logits, "prefill logits")
    _compare_cache(rj.cache, rt.cache, "prefill")
    assert np.array_equal(np.asarray(rj.m_state), rt.m_state.numpy())
    for k in ("moe_stats", "expert_stats", "slot_stats"):
        assert np.array_equal(np.asarray(rj.aux[k]), rt.aux[k].numpy()), k
    if cfg_t.moe is not None:
        assert (float(rt.aux["fp4_ranks"]) > 0) == (policy == "fp4")
    if policy != "fp4":
        return       # the decode path is the same with FP4 off (time)

    # two decode steps; row 1 idle (pos = L: its KV write drops, its SSM
    # state advances unmasked, as the reference's does)
    dec = jax.jit(partial(jtf.decode_forward, cfg=cfg_j, rcfg=jr))
    cj, ct, mj, mt = rj.cache, rt.cache, rj.m_state, rt.m_state
    for step in range(2):
        db = {"tokens": rng.integers(0, cfg_j.vocab_size, (B, 1))
              .astype(np.int32),
              "pos": np.array([S + step, L, S + step], np.int32),
              "modality": np.array([[True], [False], [False]]),
              "valid": np.array([[True], [False], [True]])}
        dj = dec(params, batch=jax.tree.map(jnp.asarray, db), cache=cj,
                 m_state=mj)
        dt = ttf.decode_forward(tparams, cfg_t, tr, _torch(db), ct, mt)
        _compare(dj.logits, dt.logits, f"decode {step} logits")
        _compare_cache(dj.cache, dt.cache, f"decode {step}")
        assert np.array_equal(np.asarray(dj.m_state), dt.m_state.numpy())
        for k in ("moe_stats", "expert_stats", "slot_stats"):
            assert np.array_equal(np.asarray(dj.aux[k]),
                                  dt.aux[k].numpy()), (step, k)
        cj, ct, mj, mt = dj.cache, dt.cache, dj.m_state, dt.m_state


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(models, arch):
    """The reference's own check in the port: decode(token s | cache of s
    tokens) equals prefill(s + 1 tokens) within rtol = atol = 2e-3."""
    _, _, cfg, _, params = models(arch)
    rcfg = TCfg(gate_gamma=4)
    rng = np.random.default_rng(2)
    b, s = 2, 12
    full = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1))
                            .astype(np.int32))
    m = torch.full((1, 1), rcfg.md_init)
    ref = ttf.prefill_forward(params, cfg, rcfg, {"tokens": full}, m,
                              cache_len=s + 1)
    res = ttf.prefill_forward(params, cfg, rcfg, {"tokens": full[:, :s]}, m,
                              cache_len=s + 1)
    dec = ttf.decode_forward(params, cfg, rcfg, {
        "tokens": full[:, s:], "pos": torch.full((b,), s,
                                                 dtype=torch.int32)},
        res.cache, res.m_state)
    np.testing.assert_allclose(dec.logits.numpy(), ref.logits.numpy(),
                               rtol=2e-3, atol=2e-3)


def _serve(engine, specs, clock):
    pending = sorted(specs, key=lambda s: s.arrival)
    while len(engine.scheduler.finished) < len(specs):
        now = clock()
        while pending and pending[0].arrival <= now:
            engine.submit(pending.pop(0).to_request())
        if engine.scheduler.idle and pending:
            clock.advance(pending[0].arrival - now)
            continue
        engine.step()
    return {r.uid: r for r in engine.scheduler.finished}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(models, arch):
    arch, cfg_j, cfg_t, params, tparams = models(arch)
    acfg = dict(kind="poisson", rate=40.0, n_requests=N_REQ, seed=0)
    specs_j = make_stream(profile("MMMU"), arrival_times(ArrivalConfig(
        **acfg)), cfg_j.vocab_size, seed=1, max_prompt=MAX_PROMPT)
    specs_t = t_multimodal.make_stream(
        t_multimodal.profile("MMMU"),
        t_arrivals.arrival_times(t_arrivals.ArrivalConfig(**acfg)),
        cfg_t.vocab_size, seed=1, max_prompt=MAX_PROMPT)

    clock_j = VirtualClock()
    eng_j = JEngine(cfg_j, params, JCfg(**ENGINE_POLICY), clock=clock_j,
                    cost_model=IterationCostModel(), **ENGINE)
    done_j = _serve(eng_j, specs_j, clock_j)
    clock_t = t_arrivals.VirtualClock()
    eng_t = TEngine(cfg_t, tparams, TCfg(**ENGINE_POLICY), clock=clock_t,
                    cost_model=t_arrivals.IterationCostModel(),
                    device="cpu", **ENGINE)
    done_t = _serve(eng_t, specs_t, clock_t)

    assert not eng_j.chunked and not eng_t.chunked
    assert set(done_j) == set(done_t) == set(range(N_REQ))
    for uid in done_j:
        rj, rt = done_j[uid], done_t[uid]
        assert rj.generated == rt.generated, uid
        assert rj.first_token_time == rt.first_token_time, uid
        assert rj.finish_time == rt.finish_time, uid
    assert len(eng_j.stats) == len(eng_t.stats)
    fields = [f.name for f in dataclasses.fields(eng_t.stats[0])]
    for i, (sj, st) in enumerate(zip(eng_j.stats, eng_t.stats)):
        for f in fields:
            assert getattr(sj, f) == getattr(st, f), (i, f)
    assert np.array_equal(np.asarray(eng_j.m_state), eng_t.m_state.numpy())
    if cfg_t.moe is not None:
        pre = [s for s in eng_t.stats if s.phase == "prefill"]
        assert any(s.fp4_ranks > 0 for s in pre)     # FP4 really fired

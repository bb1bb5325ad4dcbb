"""One-shot prefill in the port against the reference, on reduced moonshot
(4 layers, d 128, 8 experts top-2, f32): ``prefill_forward`` with FP4
forced on and off, and the engine's one-shot path (``prefill_budget=0``,
and a chunked engine sent requests carrying vision embeds) on one seeded
MMMU stream in virtual time.

Sizes are those of ``test_torch_model.py`` and ``test_torch_engine.py``
(16-token prompts), where their tolerance was measured.  The f32 gap
between the packages grows with the prompt: on a 40-token prompt both
``chunk_forward`` and ``prefill_forward`` reach 6e-5 of the logits' largest
value, and a 24-token stream flips one routing choice; there the port's
one-shot prefill is held against its own ``chunk_forward`` instead, which
it equals bit for bit."""
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
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.workloads import arrivals as t_arrivals
from repro_torch.workloads import multimodal as t_multimodal

ARCH = "moonshot-v1-16b-a3b"
VEP = 4
# test_torch_model.py's model-level tolerance: XLA's and torch's f32
# transcendentals differ by an ulp, and the residual stream carries that
# into every projection, so an element's error scales with the tensor's
# largest value
RTOL, ATOL_REL = 1e-4, 3e-5
FORCED = {"fp4": dict(gate_gamma=0, capacity_c=0.0, md_init=0.0,
                      adaptive=False),
          "bf16": dict(gate_gamma=10 ** 9)}
POLICY = dict(gate_gamma=16, md_init=0.0)        # adaptive AIMD, gate opens


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one worker per core."""
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


def _compare(j, t, what):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, err_msg=what, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(j).max()))


@pytest.mark.parametrize("policy", list(FORCED))
def test_prefill_forward_matches_reference(model, policy):
    """Logits and the padded cache at the model-level tolerance; routing
    stats and ``m_state`` exact; vision embeds ignored by the MoE backbone
    in both."""
    cfg_j, cfg_t, params, tparams = model
    kw = FORCED[policy]
    rng = np.random.default_rng(2)
    s, cache_len = 16, 64
    batch = {"tokens": rng.integers(0, cfg_j.vocab_size, (1, s))
             .astype(np.int32),
             "modality": rng.random((1, s)) < 0.7,
             "vision_embeds": (rng.standard_normal((1, 11, cfg_j.d_model))
                               * 0.02).astype(np.float32)}
    m = np.zeros((1, VEP), np.float32)
    res_j = jax.jit(partial(jtf.prefill_forward, cfg=cfg_j, rcfg=JCfg(**kw),
                            cache_len=cache_len))(
        params, batch=jax.tree.map(jnp.asarray, batch),
        m_state=jnp.asarray(m))
    res_t = ttf.prefill_forward(
        tparams, cfg_t, TCfg(**kw),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(m), cache_len=cache_len)
    fired = float(res_t.aux["fp4_ranks"]) > 0
    assert fired == (policy == "fp4")
    _compare(res_j.logits, res_t.logits, "prefill logits")
    assert np.array_equal(np.asarray(res_j.m_state), res_t.m_state.numpy())
    for k in ("moe_stats", "expert_stats", "slot_stats"):
        assert np.array_equal(np.asarray(res_j.aux[k]),
                              res_t.aux[k].numpy()), k
    for group in ("prefix", "blocks"):
        for layer, kv in res_j.cache[group].items():
            for n in ("k", "v"):
                got = res_t.cache[group][layer][n]
                assert tuple(got.shape) == kv[n].shape
                assert not got[..., s:, :, :].any()      # zero padding
                _compare(kv[n], got, f"{group}/{layer}/{n}")
    no_embeds = dict(batch)
    del no_embeds["vision_embeds"]
    plain = ttf.prefill_forward(
        tparams, cfg_t, TCfg(**kw),
        {k: torch.from_numpy(v) for k, v in no_embeds.items()},
        torch.from_numpy(m), cache_len=cache_len)
    assert torch.equal(plain.logits, res_t.logits)


@pytest.mark.parametrize("policy", list(FORCED))
def test_prefill_forward_equals_chunk_forward(model, policy):
    """On a 40-token prompt the port's one-shot prefill equals its chunked
    prefill of the whole prompt in one chunk: logits, cache rows, routing
    stats and ``m_state``, bit for bit."""
    _, cfg_t, _, tparams = model
    kw = FORCED[policy]
    rng = np.random.default_rng(3)
    s, cache_len = 40, 64
    tokens = torch.from_numpy(rng.integers(0, cfg_t.vocab_size, (1, s))
                              .astype(np.int32))
    mod = torch.from_numpy(rng.random((1, s)) < 0.7)
    m = torch.zeros((1, VEP))
    pre = ttf.prefill_forward(tparams, cfg_t, TCfg(**kw),
                              {"tokens": tokens, "modality": mod}, m,
                              cache_len=cache_len)
    chunk = ttf.chunk_forward(
        tparams, cfg_t, TCfg(**kw),
        {"tokens": tokens, "modality": mod,
         "start": torch.zeros(1, dtype=torch.int32),
         "chunk_len": torch.tensor([s], dtype=torch.int32)},
        ttf.init_cache(cfg_t, 1, cache_len, "cpu"), m)
    assert torch.equal(pre.logits, chunk.logits)
    assert torch.equal(pre.m_state, chunk.m_state)
    for k in ("moe_stats", "expert_stats", "slot_stats"):
        assert torch.equal(pre.aux[k], chunk.aux[k]), k
    for group in ("prefix", "blocks"):
        for layer, kv in pre.cache[group].items():
            for n in ("k", "v"):
                assert torch.equal(kv[n], chunk.cache[group][layer][n])


def _streams(cfg_j, cfg_t, n_req, max_prompt, embeds):
    acfg = dict(kind="poisson", rate=40.0, n_requests=n_req, seed=0)
    specs_j = make_stream(profile("MMMU"), arrival_times(ArrivalConfig(
        **acfg)), cfg_j.vocab_size, seed=1, max_prompt=max_prompt,
        with_embeds=embeds)
    specs_t = t_multimodal.make_stream(
        t_multimodal.profile("MMMU"),
        t_arrivals.arrival_times(t_arrivals.ArrivalConfig(**acfg)),
        cfg_t.vocab_size, seed=1, max_prompt=max_prompt,
        with_embeds=embeds)
    return specs_j, specs_t


def _serve(engine, specs, clock, d_model):
    """Serve ``specs`` in virtual time; even uids carry vision embeds when
    ``d_model`` is set."""
    pending = sorted(specs, key=lambda s: s.arrival)
    while len(engine.scheduler.finished) < len(specs):
        now = clock()
        while pending and pending[0].arrival <= now:
            spec = pending.pop(0)
            engine.submit(spec.to_request(d_model if spec.uid % 2 == 0
                                          else 0))
        if engine.scheduler.idle and pending:
            clock.advance(pending[0].arrival - now)
            continue
        engine.step()
    return {r.uid: r for r in engine.scheduler.finished}


def _serve_both(model, engine_kw, embeds, n_req=6, max_prompt=16):
    cfg_j, cfg_t, params, tparams = model
    specs_j, specs_t = _streams(cfg_j, cfg_t, n_req, max_prompt, embeds)
    d_model = cfg_j.d_model if embeds else 0
    clock_j = VirtualClock()
    eng_j = JEngine(cfg_j, params, JCfg(**POLICY), clock=clock_j,
                    cost_model=IterationCostModel(), **engine_kw)
    done_j = _serve(eng_j, specs_j, clock_j, d_model)
    clock_t = t_arrivals.VirtualClock()
    eng_t = TEngine(cfg_t, tparams, TCfg(**POLICY), clock=clock_t,
                    cost_model=t_arrivals.IterationCostModel(),
                    device="cpu", **engine_kw)
    done_t = _serve(eng_t, specs_t, clock_t, d_model)
    return specs_t, eng_j, done_j, eng_t, done_t


def _assert_same_run(eng_j, done_j, eng_t, done_t):
    assert set(done_j) == set(done_t)
    for uid in done_j:
        rj, rt = done_j[uid], done_t[uid]
        assert rj.generated == rt.generated, uid
        assert rj.first_token_time == rt.first_token_time, uid
        assert rj.finish_time == rt.finish_time, uid
    assert len(eng_j.stats) == len(eng_t.stats)
    fields = [f.name for f in dataclasses.fields(eng_t.stats[0])]
    for i, (sj, st) in enumerate(zip(eng_j.stats, eng_t.stats)):
        for f in fields:
            assert getattr(sj, f) == getattr(st, f), (i, f, getattr(sj, f),
                                                      getattr(st, f))
    assert np.array_equal(np.asarray(eng_j.m_state), eng_t.m_state.numpy())


def test_oneshot_engine_matches_reference(model):
    """``prefill_budget=0``: every request prefilled whole at admission;
    tokens, timestamps, ``IterStats`` and ``m_state`` equal the
    reference's, and FP4 fires in prefill."""
    kw = dict(max_slots=4, max_len=64, prefill_budget=0, virtual_ep=VEP)
    specs, eng_j, done_j, eng_t, done_t = _serve_both(model, kw, False)
    assert not eng_t.chunked
    _assert_same_run(eng_j, done_j, eng_t, done_t)
    pre = [s for s in eng_t.stats if s.phase == "prefill"]
    assert len(pre) == len(specs)                       # one per request
    assert [s.batch_tokens for s in pre] == [s.tokens for s in pre]
    assert any(s.fp4_ranks > 0 for s in pre)


def test_chunked_engine_routes_embeds_oneshot(model):
    """A chunked engine sent requests carrying vision embeds prefills
    those whole (batch 1) and the others in chunks, in both packages."""
    kw = dict(max_slots=4, max_len=64, prefill_budget=16, virtual_ep=VEP)
    specs, eng_j, done_j, eng_t, done_t = _serve_both(model, kw, True)
    assert eng_t.chunked
    _assert_same_run(eng_j, done_j, eng_t, done_t)
    with_embeds = {s.uid for s in specs
                   if s.embed_seed is not None and s.uid % 2 == 0}
    assert with_embeds and len(with_embeds) < len(specs)
    oneshot = [s for s in eng_t.stats if s.phase == "prefill"
               and s.n_active == 1 and s.batch_tokens == s.tokens]
    assert len(oneshot) >= len(with_embeds)
    assert any(s.batch_tokens > s.tokens for s in eng_t.stats
               if s.phase == "prefill")                # chunked rows too

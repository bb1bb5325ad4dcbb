"""The port's serving engine against the reference's, in virtual time, on
one seeded MMMU stream with FP4 firing in prefill: the same generated
tokens, per-iteration routing stats, AIMD state and request timestamps."""
import dataclasses

import jax
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
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.workloads import arrivals as t_arrivals
from repro_torch.workloads import multimodal as t_multimodal

ARCH = "moonshot-v1-16b-a3b"
POLICY = dict(gate_gamma=16, md_init=0.0)        # adaptive AIMD, gate opens
ENGINE = dict(max_slots=4, max_len=64, prefill_budget=16, virtual_ep=4)
N_REQ, MAX_PROMPT = 6, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one worker per core, and these
    tiny tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def served():
    cfg_j, cfg_t = jreduced(jget(ARCH)), reduced(get_config(ARCH))
    params = jtf.init_model(cfg_j, jax.random.PRNGKey(0))
    acfg = dict(kind="poisson", rate=40.0, n_requests=N_REQ, seed=0)
    specs_j = make_stream(profile("MMMU"), arrival_times(ArrivalConfig(
        **acfg)), cfg_j.vocab_size, seed=1, max_prompt=MAX_PROMPT)
    specs_t = t_multimodal.make_stream(
        t_multimodal.profile("MMMU"),
        t_arrivals.arrival_times(t_arrivals.ArrivalConfig(**acfg)),
        cfg_t.vocab_size, seed=1, max_prompt=MAX_PROMPT)

    clock_j = VirtualClock()
    eng_j = JEngine(cfg_j, params, JCfg(**POLICY), clock=clock_j,
                    cost_model=IterationCostModel(), **ENGINE)
    done_j = _serve(eng_j, specs_j, clock_j)

    clock_t = t_arrivals.VirtualClock()
    eng_t = TEngine(cfg_t, params_from_numpy(jax.tree.map(np.asarray, params),
                                      device="cpu"),
                    TCfg(**POLICY), clock=clock_t,
                    cost_model=t_arrivals.IterationCostModel(),
                    device="cpu", **ENGINE)
    done_t = _serve(eng_t, specs_t, clock_t)
    return specs_j, specs_t, eng_j, done_j, eng_t, done_t


def test_streams_are_identical(served):
    specs_j, specs_t = served[:2]
    assert len(specs_j) == len(specs_t) == N_REQ
    for a, b in zip(specs_j, specs_t):
        assert a.arrival == b.arrival and a.max_new_tokens == \
            b.max_new_tokens and a.decode_modality == b.decode_modality
        assert np.array_equal(a.tokens, b.tokens)
        assert np.array_equal(a.modality, b.modality)


def test_generated_tokens_and_times_equal(served):
    _, _, _, done_j, _, done_t = served
    assert set(done_j) == set(done_t) == set(range(N_REQ))
    for uid in done_j:
        rj, rt = done_j[uid], done_t[uid]
        assert rj.generated == rt.generated, uid
        assert rj.first_token_time == rt.first_token_time, uid
        assert rj.finish_time == rt.finish_time, uid
        assert rj.ttft == rt.ttft and rj.tpot == rt.tpot, uid


def test_iteration_stats_equal_with_fp4_firing(served):
    _, _, eng_j, _, eng_t, _ = served
    assert len(eng_j.stats) == len(eng_t.stats)
    fields = [f.name for f in dataclasses.fields(eng_t.stats[0])]
    for i, (sj, st) in enumerate(zip(eng_j.stats, eng_t.stats)):
        for f in fields:
            assert getattr(sj, f) == getattr(st, f), (i, f, getattr(sj, f),
                                                      getattr(st, f))
    pre = [s for s in eng_t.stats if s.phase == "prefill"]
    assert any(s.fp4_ranks > 0 for s in pre)        # FP4 really fired
    assert any(s.phase == "decode" for s in eng_t.stats)


def test_m_state_equal(served):
    _, _, eng_j, _, eng_t, _ = served
    assert np.array_equal(np.asarray(eng_j.m_state), eng_t.m_state.numpy())


def test_engine_refuses_oversized_request(served):
    eng_t = served[4]
    from repro_torch.serving.scheduler import Request
    with pytest.raises(ValueError):
        eng_t.submit(Request(uid=99, tokens=np.zeros(60, np.int32),
                             modality=np.zeros(60, bool), max_new_tokens=8))
    assert torch.is_tensor(eng_t.m_state)

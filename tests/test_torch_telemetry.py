"""The port's telemetry and record/replay against the reference's: one
virtual-time stream served by both engines gives equal
``Telemetry.summary()`` dicts, the collectors agree on synthetic feeds, and
a stream saved by either package loads identically in the other."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import transformer as jtf
from repro.serving import telemetry as jtel
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import IterStats as JIterStats
from repro.serving.scheduler import Request as JRequest
from repro.workloads import (ArrivalConfig, IterationCostModel, VirtualClock,
                             arrival_times, make_stream, profile)
from repro.workloads import replay as jreplay
from repro_torch import obs as tobs
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.serving import telemetry as ttel
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import IterStats as TIterStats
from repro_torch.serving.scheduler import Request as TRequest
from repro_torch.workloads import (load_stream, save_stream)
from repro_torch.workloads import arrivals as t_arrivals
from repro_torch.workloads import multimodal as t_multimodal

ARCH = "moonshot-v1-16b-a3b"
POLICY = dict(gate_gamma=16, md_init=0.0)
ENGINE = dict(max_slots=4, max_len=64, prefill_budget=16, virtual_ep=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs(vocab_j, vocab_t, n_req=6, with_embeds=False):
    acfg = dict(kind="poisson", rate=40.0, n_requests=n_req, seed=0)
    return (make_stream(profile("MMMU"), arrival_times(ArrivalConfig(**acfg)),
                        vocab_j, seed=1, max_prompt=16,
                        with_embeds=with_embeds),
            t_multimodal.make_stream(
                t_multimodal.profile("MMMU"),
                t_arrivals.arrival_times(t_arrivals.ArrivalConfig(**acfg)),
                vocab_t, seed=1, max_prompt=16, with_embeds=with_embeds))


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


def test_engine_telemetry_summary_equals_reference():
    """Both engines feed their collector at the same points (every
    recorded iteration, every finished request): equal summaries."""
    cfg_j, cfg_t = jreduced(jget(ARCH)), reduced(get_config(ARCH))
    params = jtf.init_model(cfg_j, jax.random.PRNGKey(0))
    specs_j, specs_t = _specs(cfg_j.vocab_size, cfg_t.vocab_size)
    tel_j, tel_t = jtel.Telemetry(), ttel.Telemetry()
    clock_j = VirtualClock()
    _serve(JEngine(cfg_j, params, JCfg(**POLICY), clock=clock_j,
                   telemetry=tel_j, cost_model=IterationCostModel(),
                   **ENGINE), specs_j, clock_j)
    clock_t = t_arrivals.VirtualClock()
    eng_t = TEngine(cfg_t, params_from_numpy(jax.tree.map(np.asarray, params),
                                             "cpu"),
                    TCfg(**POLICY), clock=clock_t, telemetry=tel_t,
                    cost_model=t_arrivals.IterationCostModel(),
                    device="cpu", **ENGINE)
    _serve(eng_t, specs_t, clock_t)
    sj, st = tel_j.summary(), tel_t.summary()
    assert sj == st
    assert st["n_requests"] == len(specs_t)
    assert st["n_iters"] == len(eng_t.stats) > 0
    assert st["fp4_duty_prefill"] > 0 and st["ttft"] and st["tpot"]
    ttft = sorted(r.ttft for r in eng_t.scheduler.finished)
    assert st["ttft"]["p50"] == tobs.percentile(ttft, 50)


def test_collectors_agree_on_synthetic_feeds():
    """Iteration stats with migration, split, drop and degraded fields
    set, and requests of both modalities, through both collectors (a
    window of 8 to exercise the rolling deques)."""
    rng = np.random.default_rng(0)
    tel_j, tel_t = jtel.Telemetry(window=8), ttel.Telemetry(window=8)
    for i in range(20):
        kw = dict(n_active=int(rng.integers(1, 5)), tokens=int(i * 3 + 1),
                  ib_global=float(rng.random() * 2), fp4_ranks=float(i % 3),
                  gate_open=float(i % 2), phase=("prefill", "decode")[i % 2],
                  t_wall=0.1 * i, batch_tokens=32, vis_frac=0.5,
                  drop_frac=float(rng.random() * 0.1),
                  migration_bytes=int(i % 4) * 1000,
                  migration_s=0.01 * (i % 4), migration_hidden_s=0.002,
                  split_frac=0.1 * (i % 5), n_unroutable=int(i % 7 == 0),
                  lost_tokens=0.5 * (i % 7 == 0))
        assert [f.name for f in dataclasses.fields(TIterStats)] == \
            [f.name for f in dataclasses.fields(JIterStats)]
        tel_j.record_iter(JIterStats(**kw))
        tel_t.record_iter(TIterStats(**kw))
    for uid in range(12):
        n = int(rng.integers(4, 12))
        mod = rng.random(n) < 0.6
        reqs = [cls(uid=uid, tokens=np.zeros(n, np.int32), modality=mod,
                    max_new_tokens=3, arrival_time=0.5 * uid)
                for cls in (JRequest, TRequest)]
        for r in reqs:
            r.generated = list(range(1 + uid % 3))
            r.first_token_time = 0.5 * uid + 0.05 * (uid + 1)
            r.finish_time = r.first_token_time + 0.02 * uid
        tel_j.record_request(reqs[0])
        tel_t.record_request(reqs[1])
    tel_j.record_recovery(1.5)
    tel_t.record_recovery(1.5)
    assert tel_j.summary() == tel_t.summary()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_stream_replays_in_the_other_package(tmp_path, writer):
    """A stream (with embed seeds) saved by either package loads into the
    same specs in both, and its header metadata survives."""
    specs_j, specs_t = _specs(512, 512, n_req=8, with_embeds=True)
    path = tmp_path / "stream.jsonl"
    meta = {"workload": "MMMU", "seed": 1}
    if writer == "reference":
        jreplay.save_stream(path, specs_j, meta)
    else:
        save_stream(path, specs_t, meta)
    meta_j, got_j = jreplay.load_stream(path)
    meta_t, got_t = load_stream(path)
    assert meta_j == meta_t == meta
    assert len(got_j) == len(got_t) == len(specs_t)
    assert any(s.embed_seed is not None for s in got_t)
    for a, b, c in zip(got_j, got_t, specs_t):
        for f in ("uid", "arrival", "max_new_tokens", "decode_modality",
                  "embed_seed"):
            assert getattr(a, f) == getattr(b, f) == getattr(c, f), f
        for f in ("tokens", "modality"):
            assert np.array_equal(getattr(a, f), getattr(b, f))
            assert np.array_equal(getattr(b, f), getattr(c, f))
            assert getattr(b, f).dtype == getattr(c, f).dtype

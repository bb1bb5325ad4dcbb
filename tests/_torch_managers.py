"""Shared pieces of the placement/replication parity tests: the reference's
and the port's manager classes side by side, seeded stats streams, and one
serving arm run through both engines in virtual time."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import PlacementConfig as JPCfg
from repro.configs import ReaLBConfig as JCfg
from repro.configs import ReplicationConfig as JRCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import transformer as jtf
from repro.obs.trace import Tracer as JTracer
from repro.placement import PlacementManager as JPM
from repro.replication import ReplicaManager as JRM
from repro.replication import expand_moe_params as jexpand
from repro.serving.engine import Engine as JEngine
from repro.serving.telemetry import Telemetry as JTelemetry
from repro.workloads import (ArrivalConfig, IterationCostModel, VirtualClock,
                             arrival_times, make_stream, profile)
from repro_torch.configs import PlacementConfig as TPCfg
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import ReplicationConfig as TRCfg
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.obs.trace import Tracer as TTracer
from repro_torch.placement import PlacementManager as TPM
from repro_torch.replication import ReplicaManager as TRM
from repro_torch.replication import expand_moe_params as texpand
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.telemetry import Telemetry as TTelemetry
from repro_torch.workloads import arrivals as t_arrivals
from repro_torch.workloads import multimodal as t_multimodal

ARCH = "moonshot-v1-16b-a3b"
EP = 4
POLICY = dict(gate_gamma=16, md_init=0.0)        # adaptive AIMD, FP4 fires
# 16-token prompts: on longer streams some routing choice lies within the
# packages' f32 gap of its top-k margin (tests/test_torch_prompt_margin.py)
ENGINE = dict(max_slots=4, max_len=64, prefill_budget=16, virtual_ep=EP)
N_REQ, MAX_PROMPT = 8, 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs one worker per core, and these tiny
    tensors gain nothing from intra-op threads (import it into a test
    module to use it there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def model():
    cfg_j, cfg_t = jreduced(jget(ARCH)), reduced(get_config(ARCH))
    params = jtf.init_model(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params, jax.tree.map(np.asarray, params)


def managers(cfg_j, cfg_t, kind, cost_gates=(None, None), **kw):
    """The reference's and the port's manager of one configuration."""
    if kind == "placement":
        return (JPM(cfg_j, JPCfg(**kw), EP, cost_gate=cost_gates[0]),
                TPM(cfg_t, TPCfg(**kw), EP, cost_gate=cost_gates[1]))
    return (JRM(cfg_j, JRCfg(**kw), EP, cost_gate=cost_gates[0]),
            TRM(cfg_t, TRCfg(**kw), EP, cost_gate=cost_gates[1]))


def stats_stream(n_iters, n_layers, n_experts, n_slots=None, seed=0):
    """Seeded per-iteration ``(expert_stats [L, 2, E], slot_stats [L, 2, S],
    decode)`` with a skew that drifts over the stream (integer counts, as
    the engine's stats are)."""
    rng = np.random.default_rng(seed)
    n_slots = n_slots or n_experts
    out = []
    for it in range(n_iters):
        hot = np.exp(rng.normal(0.0, 1.0 + 0.05 * it, (n_layers, n_experts)))
        load = rng.poisson(8.0 * hot / hot.mean()).astype(np.float64)
        vis = np.floor(load * rng.random((n_layers, n_experts)))
        slots = rng.poisson(8.0, (n_layers, 2, n_slots)).astype(np.float64)
        out.append((np.stack([load, vis], axis=1), slots, bool(it % 3 == 2)))
    return out


def state_equal(a, b):
    """Two managers' ``state_dict``s hold the same keys and bytes."""
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), k
        assert np.asarray(sa[k]).dtype == np.asarray(sb[k]).dtype, k


def tables_equal(a, b):
    ta, tb = a.device_tables(), b.device_tables()
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert np.array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


def plan_equal(pj, pt):
    """Two staged plans: the same class name and the same arrays."""
    assert (pj is None) == (pt is None)
    if pj is None:
        return
    assert type(pj).__name__ == type(pt).__name__
    for f in dataclasses.fields(pj):
        a, b = getattr(pj, f.name), getattr(pt, f.name)
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), f.name
        elif isinstance(a, tuple):             # pending per-layer states
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                _state_equal(x, y)
        elif f.name in ("new_table", "new_set"):
            _state_equal(a, b)
        else:
            assert a == b, f.name


def _state_equal(a, b):
    """Two tables (or replica sets): the same fields, arrays bitwise."""
    for g in dataclasses.fields(a):
        assert np.array_equal(np.asarray(getattr(a, g.name)),
                              np.asarray(getattr(b, g.name))), g.name


def _serve(engine, specs, clock, mgr, tables, after_step=None):
    pending = sorted(specs, key=lambda s: s.arrival)
    while len(engine.scheduler.finished) < len(specs):
        now = clock()
        while pending and pending[0].arrival <= now:
            engine.submit(pending.pop(0).to_request())
        if engine.scheduler.idle and pending:
            clock.advance(pending[0].arrival - now)
            continue
        engine.step()
        tables.append([np.asarray(a).copy() for a in mgr.device_tables()])
        if after_step is not None:
            after_step(engine)
    return {r.uid: r for r in engine.scheduler.finished}


ARMS = {
    "placement": ("placement", dict(planner="least_loaded"), {}),
    "replicate": ("replication", dict(spare_per_rank=1, max_replicas=2,
                                      weighted_split=True),
                  dict(capacity_margin=1.25)),
    "placement/L": ("placement", dict(planner="least_loaded",
                                      per_layer=True), {}),
    "replicate/L": ("replication", dict(spare_per_rank=1, max_replicas=2,
                                        per_layer=True), {}),
    "placement/L/async": ("placement", dict(planner="least_loaded",
                                            per_layer=True,
                                            max_changed_layers=2),
                          dict(migrate_async=True)),
    "replicate/L/async": ("replication", dict(spare_per_rank=1,
                                              max_replicas=2, per_layer=True,
                                              weighted_split=True),
                          dict(migrate_async=True, capacity_margin=1.25)),
}


@dataclasses.dataclass
class ArmRun:
    """Both engines of one arm after serving the stream, with what was
    recorded along the way."""
    eng_j: object
    eng_t: object
    done_j: dict
    done_t: dict
    tables_j: list
    tables_t: list
    tel_j: object
    tel_t: object
    observed_j: list
    observed_t: list
    n_req: int


def run_arm(arm, trace=False, n_req=N_REQ, extra=None, before=None,
            after_step=None, ref=True):
    """One seeded MMMU stream through the reference's and the port's engine
    with the arm's manager.  The bandwidth EWMA sees each gather's bytes
    but not its wall seconds (they differ from run to run), so both price
    migrations at the configured prior.  ``trace`` gives each engine a
    span tracer on its virtual clock.  ``extra(mj, mt, clock_j, clock_t,
    tel_j, tel_t)`` returns more engine arguments for each engine (a
    profiler, an elastic coordinator); ``before(eng_j, eng_t)`` runs before
    serving; ``after_step(engine)`` runs after every step of either.
    ``ref=False`` serves the port's engine only (``done_j`` empty)."""
    kind, mcfg, ekw = ARMS[arm]
    cfg_j, cfg_t, params, pnum = model()
    mj, mt = managers(cfg_j, cfg_t, kind, replan_every=4, warmup_iters=2,
                      min_gain=0.0, **mcfg)
    observed = ([], [])
    for m, log in zip((mj, mt), observed):
        m.bandwidth.observe = lambda nbytes, s, log=log: log.append(nbytes)
    pt = params_from_numpy(pnum, "cpu")
    if kind == "replication":
        lay_j = mj.rsets if mj.per_layer else mj.rset
        lay_t = mt.rsets if mt.per_layer else mt.rset
        params, pt = jexpand(params, lay_j), texpand(pt, lay_t)
    if ekw.get("migrate_async"):
        # about two changed experts' slabs of one block an iteration
        ekw = dict(ekw, migrate_bytes_per_iter=2 * mj.bytes_per_expert)
    acfg = dict(kind="poisson", rate=40.0, n_requests=n_req, seed=0)
    specs_j = make_stream(profile("MMMU"), arrival_times(ArrivalConfig(
        **acfg)), cfg_j.vocab_size, seed=1, max_prompt=MAX_PROMPT)
    specs_t = t_multimodal.make_stream(
        t_multimodal.profile("MMMU"),
        t_arrivals.arrival_times(t_arrivals.ArrivalConfig(**acfg)),
        cfg_t.vocab_size, seed=1, max_prompt=MAX_PROMPT)
    tel_j, tel_t = JTelemetry(), TTelemetry()
    clock_j, clock_t = VirtualClock(), t_arrivals.VirtualClock()
    tracers = (JTracer(clock_j), TTracer(clock_t)) if trace else (None, None)
    kw_j, kw_t = extra(mj, mt, clock_j, clock_t, tel_j, tel_t) \
        if extra is not None else ({}, {})
    eng_j = JEngine(cfg_j, params, JCfg(**POLICY), clock=clock_j,
                    cost_model=IterationCostModel(), placement=mj,
                    telemetry=tel_j, tracer=tracers[0], **ekw, **ENGINE,
                    **kw_j)
    eng_t = TEngine(cfg_t, pt, TCfg(**POLICY), clock=clock_t,
                    cost_model=t_arrivals.IterationCostModel(), placement=mt,
                    telemetry=tel_t, tracer=tracers[1], device="cpu", **ekw,
                    **ENGINE, **kw_t)
    if before is not None:
        before(eng_j, eng_t)
    tables_j, tables_t = [], []
    done_j = _serve(eng_j, specs_j, clock_j, mj, tables_j, after_step) \
        if ref else {}
    done_t = _serve(eng_t, specs_t, clock_t, mt, tables_t, after_step)
    return ArmRun(eng_j, eng_t, done_j, done_t, tables_j, tables_t, tel_j,
                  tel_t, observed[0], observed[1], n_req)


def assert_streams_equal(run: ArmRun):
    """Tokens, every IterStats field, the routable tables after every
    iteration, the telemetry's commits and prediction windows, and the
    bytes each timed gather reported."""
    assert set(run.done_j) == set(run.done_t) == set(range(run.n_req))
    for uid in run.done_j:
        assert run.done_j[uid].generated == run.done_t[uid].generated, uid
        assert run.done_j[uid].finish_time == run.done_t[uid].finish_time
    sj, st = run.eng_j.stats, run.eng_t.stats
    assert len(sj) == len(st)
    for i, (a, b) in enumerate(zip(sj, st)):
        for f in dataclasses.fields(b):
            assert getattr(a, f.name) == getattr(b, f.name), (i, f.name)
    assert len(run.tables_j) == len(run.tables_t)
    for i, (a, b) in enumerate(zip(run.tables_j, run.tables_t)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b)), i
    assert run.tel_j.n_plans_committed == run.tel_t.n_plans_committed > 0
    assert run.tel_j.prediction.windows == run.tel_t.prediction.windows
    assert run.tel_j.prediction.summary() == run.tel_t.prediction.summary()
    assert len(run.tel_j.prediction.windows) > 0
    assert run.observed_j == run.observed_t
    assert np.array_equal(np.asarray(run.eng_j.m_state),
                          run.eng_t.m_state.numpy())
    assert run.eng_j.migration_bytes_moved == run.eng_t.migration_bytes_moved
    assert run.eng_j.cfg.moe.capacity_factor == \
        run.eng_t.cfg.moe.capacity_factor


def ep_ref_arm(arm, mcfg, policy, engine, ep, n_req, max_prompt,
               save_to=None, faults=None, ckpt_dir=None):
    """The reference's half of an EP serving arm (the ranks serve the port's
    EP engine, ``_torch_ep_workers._serve_arm``): its engine with the
    manager of ``arm = (kind, config, engine args)`` over ``virtual_ep =
    ep``, the bandwidth EWMA at its prior, requests arriving on a virtual
    clock; with ``faults`` an elastic coordinator reading ``ckpt_dir``
    (saved before serving) and a fault injector, and the first checkpoint
    refused mid-recovery noted.  ``save_to``: a checkpoint after serving."""
    from repro.runtime.fault_tolerance import FaultInjector as JFI
    from repro.serving.elastic import ElasticCoordinator as JCo
    kind, kw, ekw = arm
    kw = dict(mcfg, **kw)
    cfg_j, _, params, _ = model()
    mj = (JPM(cfg_j, JPCfg(**kw), ep) if kind == "placement"
          else JRM(cfg_j, JRCfg(**kw), ep))
    observed = []
    mj.bandwidth.observe = lambda nbytes, s: observed.append(int(nbytes))
    if kind == "replication":
        params = jexpand(params, mj.rsets if mj.per_layer else mj.rset)
    ekw = dict(ekw)
    if ekw.get("migrate_async"):
        ekw["migrate_bytes_per_iter"] = 2 * mj.bytes_per_expert
    clock, tel = VirtualClock(), JTelemetry()
    extra, co = {}, None
    if faults:
        co = JCo(mj, ckpt_dir=ckpt_dir, clock=clock, telemetry=tel)
        extra = {"elastic": co, "fault_injector": JFI(
            [tuple(f) for f in faults])}
    eng = JEngine(cfg_j, params, JCfg(**policy), clock=clock,
                  cost_model=IterationCostModel(), placement=mj,
                  telemetry=tel, virtual_ep=ep, **ekw, **engine, **extra)
    if co is not None:
        eng.save_checkpoint(ckpt_dir, 0)
    specs = make_stream(profile("MMMU"), arrival_times(ArrivalConfig(
        kind="poisson", rate=40.0, n_requests=n_req, seed=0)),
        cfg_j.vocab_size, seed=1, max_prompt=max_prompt)
    tables, refused = [], []

    def after_step(e):
        if co is not None and co.recovering and not refused:
            try:
                e.save_checkpoint(ckpt_dir, 1)
                refused.append("saved")
            except RuntimeError as err:
                refused.append((e._it, str(err)))

    done = _serve(eng, specs, clock, mj, tables, after_step)
    out = {"tokens": {u: list(r.generated) for u, r in done.items()},
           "finish": {u: r.finish_time for u, r in done.items()},
           "stats": [dataclasses.asdict(s) for s in eng.stats],
           "tables": tables, "m": np.asarray(eng.m_state),
           "moved": eng.migration_bytes_moved, "observed": observed,
           "cap": eng.cfg.moe.capacity_factor,
           "commits": tel.n_plans_committed, "engine": eng, "manager": mj}
    if co is not None:
        out["events"] = [dict(e) for e in co.events]
        out["refused"] = refused[0] if refused else None
        out["summary"] = {k: v for k, v in tel.summary().items()
                          if k in ("availability", "degraded_iters",
                                   "n_recoveries", "recovery_s",
                                   "lost_tokens_total")}
    if save_to is not None:
        out["saved"] = eng.save_checkpoint(save_to, 5)
    return out

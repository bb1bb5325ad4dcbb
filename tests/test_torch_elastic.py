"""The port's elastic serving against the reference's: the fault injector,
in-place slab zeroing, the coordinator's refusals and its kill → degraded
→ shrunk → rejoin → warming → healthy cycle (events, lost sets and the
re-materialized rows equal to the reference's, bit for bit), checkpoint
rows read without decoding the group, the churn-budget exemption and the
event-triggered replan, a recovery patch that fails part-way, and a
serving arm with a scripted kill and rejoin against the reference's
engine in virtual time (mirrors tests/test_elastic_serving.py).

Subjects of that file covered by other port tests: masked replica sets,
the planner and capacity factors with dead ranks, split schedules and
residual split weights (``test_torch_replication.py::
test_set_views_match_reference``, ``test_planner_matches_reference``);
recovery chunks draining first (``test_torch_async_migrate.py::
test_executor_priority_layers_and_cancel``); the churn budget's cap
(``test_torch_replication.py::test_replica_manager_stream_matches_
reference[per_layer_churn]``); weighted device tables (its ``weighted``
case); telemetry availability (``test_torch_telemetry.py::
test_collectors_agree_on_synthetic_feeds``).  ``effective_mesh`` is not
ported (no mesh)."""
import jax
import numpy as np
import pytest
import torch

import _torch_managers as tm
from _torch_managers import one_torch_thread  # noqa: F401
from repro.checkpoint import ckpt as jckpt
from repro.placement.migrate import MOE_WEIGHT_KEYS
from repro.replication import ReplicaManager as JRM
from repro.replication import expand_moe_params as jexpand
from repro.replication import plan_replication as jplan
from repro.runtime.fault_tolerance import FaultInjector as JFI
from repro.serving.async_migrate import MigrationExecutor as JExec
from repro.serving.elastic import ElasticCoordinator as JCo
from repro.serving.elastic import zero_rank_slabs as jzero
from repro.serving.telemetry import Telemetry as JTel
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.replication import ReplicaManager as TRM
from repro_torch.replication import expand_moe_params as texpand
from repro_torch.replication import plan_replication as tplan
from repro_torch.replication import migrate as trm
from repro_torch.runtime.fault_tolerance import FaultEvent, FaultInjector
from repro_torch.serving.async_migrate import MigrationExecutor as TExec
from repro_torch.serving.elastic import (STATE_DEGRADED, STATE_HEALTHY,
                                         STATE_SHRUNK, STATE_WARMING,
                                         ElasticCoordinator, zero_rank_slabs)
from repro_torch.serving.telemetry import Telemetry as TTel

E, EP, SPR = 8, 4, 3          # 8 experts over 4 ranks, 1 spare slot each


class Ticks:
    """A deterministic clock both coordinators read alike."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.5
        return self.t


def _rpcfg(cls, **kw):
    base = dict(enabled=True, spare_per_rank=1, max_replicas=3,
                replan_every=1, warmup_iters=0, min_gain=0.0)
    base.update(kw)
    return cls(**base)


def _mgrs(per_layer=False, n_layers=None, **kw):
    geo = dict(bytes_per_expert=64)
    if per_layer:
        geo["n_layers"] = n_layers or 3
        kw["per_layer"] = True
    return (JRM.from_geometry(E, _rpcfg(tm.JRCfg, **kw), EP, **geo),
            TRM.from_geometry(E, _rpcfg(tm.TRCfg, **kw), EP, **geo))


def _params(mj, mt, d=4, n_layers=2, seed=0):
    """(logical numpy tree, the reference's expanded numpy tree, the
    port's expanded torch tree) with stacked [L, S, d, d] weights."""
    rng = np.random.default_rng(seed)
    logical = {"blocks": {"layer0": {"moe": {
        k: rng.normal(size=(n_layers, E, d, d)).astype(np.float32)
        for k in MOE_WEIGHT_KEYS}}}}
    tree = jax.tree.map(lambda a: torch.from_numpy(a.copy()), logical)
    return logical, jexpand(logical, mj.rsets), texpand(tree, mt.rsets)


def _observe(mgrs, load):
    """One observation of ``load`` in every layer of each manager."""
    for m in mgrs:
        row = np.stack([np.asarray(load, np.float64), np.zeros(E)])
        m.observe(np.stack([row] * (m.n_tables if m.per_layer else 1)))


def _same(pj, pt):
    for k in MOE_WEIGHT_KEYS:
        a = np.asarray(pj["blocks"]["layer0"]["moe"][k])
        b = pt["blocks"]["layer0"]["moe"][k].numpy()
        assert a.tobytes() == b.tobytes(), k


def _drain_all(mgr, co, plan, params, cls):
    ex = cls(mgr, plan, bytes_per_iter=1 << 30,
             priority_layers=co.recovery_layers(plan),
             patch_fn=co.patch_params)
    while ex.draining:
        params, rep = ex.drain(params)
        co.on_layers_landed(plan, rep.layers)
    return params


def _save(mgr, params, tmp, lib, step=0):
    lib.save(str(tmp), step, {
        "serving": {"params": params, "m_state": np.zeros((1, EP))},
        mgr.ckpt_group: mgr.state_dict()})


def _events(co):
    return [{k: v for k, v in e.items()} for e in co.events]


# --------------------------------------------------------------------------
# fault injection + slab zeroing
# --------------------------------------------------------------------------
def test_fault_injector_fires_once_in_order():
    seen = []
    for cls in (JFI, FaultInjector):
        fi = cls([(9, "rejoin", 2), (4, "fail", 2)])
        out = [fi.due(3), fi.due(5), fi.due(5)]
        ex = fi.exhausted
        out.append(fi.due(20))
        seen.append(([[(e.it, e.kind, e.rank) for e in evs] for evs in out],
                     ex, fi.exhausted))
    assert seen[0] == seen[1]
    assert seen[1][0] == [[], [(4, "fail", 2)], [], [(9, "rejoin", 2)]]
    assert seen[1][1:] == (False, True)
    fi = FaultInjector([FaultEvent(1, "fail", 0)])
    assert repr(fi.events[0]) == "FaultEvent(it=1, kind='fail', rank=0)"


def test_fault_event_rejects_unknown_kind():
    with pytest.raises(AssertionError):
        FaultEvent(1, "explode", 0)


def test_zero_rank_slabs_in_place_equals_reference():
    mj, mt = _mgrs()
    _, pj, pt = _params(mj, mt)
    w_before = pt["blocks"]["layer0"]["moe"]["w_up"]
    out_j = jzero(pj, 2, SPR)
    out_t = zero_rank_slabs(pt, 2, SPR)
    assert out_t is pt                                  # in place
    assert out_t["blocks"]["layer0"]["moe"]["w_up"] is w_before
    _same(out_j, out_t)
    w = out_t["blocks"]["layer0"]["moe"]["w_gate"]
    assert (w[:, 2 * SPR:3 * SPR] == 0).all()


# --------------------------------------------------------------------------
# coordinator state machine
# --------------------------------------------------------------------------
def test_coordinator_requires_replica_manager():
    from repro_torch.placement import PlacementManager
    pm = PlacementManager.from_geometry(E, tm.TPCfg(), EP)
    with pytest.raises(TypeError, match="ReplicaManager"):
        ElasticCoordinator(pm)


def test_fail_refusals():
    _, mt = _mgrs()
    co = ElasticCoordinator(mt)                         # no checkpoint
    # identity sets: every rank hosts singletons -> refused before any
    # state changes
    with pytest.raises(RuntimeError, match="no checkpoint"):
        co.fail_rank(1)
    assert mt.rank_alive.all() and co.state == STATE_HEALTHY


def test_fail_last_rank_and_double_fail_refused(tmp_path):
    _, mt = _mgrs()
    _save(mt, {}, tmp_path, tckpt)
    co = ElasticCoordinator(mt, ckpt_dir=str(tmp_path))
    for r in range(EP - 1):
        co.fail_rank(r)
    with pytest.raises(ValueError, match="already dead"):
        co.fail_rank(0)
    with pytest.raises(ValueError, match="last live rank"):
        co.fail_rank(EP - 1)


def test_rejoin_refused_while_live():
    _, mt = _mgrs()
    with pytest.raises(ValueError, match="already live"):
        ElasticCoordinator(mt).rejoin_rank(0)


def test_replicated_only_loss_never_degrades():
    """Every expert on the lost rank has a surviving replica: the fail is
    a table flip — no lost experts, recovery_s == 0, as the reference."""
    mj, mt = _mgrs(spare_per_rank=2, max_replicas=2)
    mj.rsets[0] = jplan(np.ones(E), EP, mj.slots_per_rank, max_replicas=2)
    mt.rsets[0] = tplan(np.ones(E), EP, mt.slots_per_rank, max_replicas=2)
    assert (mt.rset.n_rep == 2).all()
    tel_j, tel_t = JTel(), TTel()
    cj = JCo(mj, telemetry=tel_j, clock=Ticks())
    ct = ElasticCoordinator(mt, telemetry=tel_t, clock=Ticks())
    cj.fail_rank(1)
    ct.fail_rank(1)
    assert ct.state == STATE_SHRUNK and not ct.recovering
    assert ct.last_recovery_s == 0.0 == cj.last_recovery_s
    assert tel_t.recoveries == tel_j.recoveries
    assert not mt.hosts_rank(1)
    tm.state_equal(mj, mt)
    assert _events(cj) == _events(ct)


@pytest.mark.parametrize("per_layer", [False, True])
def test_kill_recover_rejoin_full_cycle_equals_reference(tmp_path,
                                                         per_layer):
    """fail -> degraded -> (recovery chunks land) -> shrunk -> rejoin ->
    warming -> healthy in lock step with the reference: the same events,
    lost sets, tables and bytes, with the lost experts re-materialized
    from the checkpoint bit for bit."""
    mj, mt = _mgrs(per_layer, n_layers=2)
    logical, pj, pt = _params(mj, mt)
    dj, dt = tmp_path / "ref", tmp_path / "port"
    cj = JCo(mj, ckpt_dir=str(dj), clock=Ticks())
    ct = ElasticCoordinator(mt, ckpt_dir=str(dt), clock=Ticks())
    load = np.ones(E)
    load[0] = 50.0
    # replicate the hot expert first, then checkpoint the replicated layout
    _observe((mj, mt), load)
    plan_j, plan_t = mj.maybe_replan(1), mt.maybe_replan(1)
    tm.plan_equal(plan_j, plan_t)
    pj = _drain_all(mj, cj, plan_j, pj, JExec)
    pt = _drain_all(mt, ct, plan_t, pt, TExec)
    _same(pj, pt)
    _save(mj, pj, dj, jckpt)
    _save(mt, pt, dt, tckpt)

    rs = mt.rsets[0]
    victim = next(r for r in range(EP)
                  if any(rs.n_rep[e] == 1 and rs.rep_pos[e, 0] // SPR == r
                         for e in range(E)))
    pj = cj.fail_rank(victim, pj)
    pt = ct.fail_rank(victim, pt)
    assert ct.state == STATE_DEGRADED == cj.state
    assert ct.lost.keys() == cj.lost.keys()
    for l in ct.lost:
        assert np.array_equal(ct.lost[l], cj.lost[l])
    assert np.array_equal(ct.lost_experts, cj.lost_experts)
    assert mt.must_layers == set(ct.lost) == mj.must_layers
    _same(pj, pt)                                       # dead slabs zeroed
    tm.tables_equal(mj, mt)

    _observe((mj, mt), load)
    plan_j, plan_t = mj.maybe_replan(2), mt.maybe_replan(2)
    tm.plan_equal(plan_j, plan_t)
    assert ct.recovery_layers(plan_t) == cj.recovery_layers(plan_j)
    pj = _drain_all(mj, cj, plan_j, pj, JExec)
    pt = _drain_all(mt, ct, plan_t, pt, TExec)
    assert ct.state == STATE_SHRUNK == cj.state
    assert ct.last_recovery_s == cj.last_recovery_s is not None
    _same(pj, pt)                                       # re-materialized
    assert ct.patched_bytes > 0
    # every routable slot holds its expert's original rows
    for k in MOE_WEIGHT_KEYS:
        w = pt["blocks"]["layer0"]["moe"][k].numpy()
        lw = logical["blocks"]["layer0"]["moe"][k]
        for l in range(w.shape[0]):
            rset = mt.rsets[l if per_layer else 0]
            for e in range(E):
                for j in range(rset.n_rep[e]):
                    slot = int(rset.rep_pos[e, j])
                    assert np.array_equal(w[l, slot], lw[l, e]), (k, e)

    cj.rejoin_rank(victim)
    ct.rejoin_rank(victim)
    assert ct.state == STATE_WARMING and not mt.hosts_rank(victim)
    _observe((mj, mt), load)
    plan_j, plan_t = mj.maybe_replan(3), mt.maybe_replan(3)
    tm.plan_equal(plan_j, plan_t)
    pj = _drain_all(mj, cj, plan_j, pj, JExec)
    pt = _drain_all(mt, ct, plan_t, pt, TExec)
    assert ct.state == STATE_HEALTHY == cj.state and mt.hosts_rank(victim)
    _same(pj, pt)
    tm.state_equal(mj, mt)
    assert _events(ct) == _events(cj)
    assert [e["kind"] for e in ct.events] == \
        ["fail", "recovered", "rejoin", "warm"]


def test_patch_reads_only_the_rows_it_writes(tmp_path, monkeypatch):
    """Re-materialization maps the saved weights and reads rows from the
    map; it never decodes the serving group."""
    mj, mt = _mgrs()
    _, _, pt = _params(mj, mt)
    _save(mt, pt, tmp_path, tckpt)
    monkeypatch.setattr(tckpt, "restore_group", None)   # must not be used
    co = ElasticCoordinator(mt, ckpt_dir=str(tmp_path))
    pt = co.fail_rank(0, pt)
    _observe((mt,), np.ones(E))
    plan = mt.maybe_replan(1)
    pt = _drain_all(mt, co, plan, pt, TExec)
    assert not co.recovering
    maps, rep_pos, _ = co._saved_cache
    assert all(isinstance(m, np.memmap) for m, _ in maps.values())
    # 2 lost experts, 2 layers, 3 weights of 4x4 f32
    assert co.patched_bytes == 2 * 2 * 3 * 4 * 4 * 4


def test_patch_params_missing_checkpoint_raises(tmp_path):
    _, mt = _mgrs()
    co = ElasticCoordinator(mt, ckpt_dir=str(tmp_path))  # empty dir
    co.lost = {0: np.array([3])}
    plan = type("P", (), {"new_set": mt.rset, "new_sets": None})()
    with pytest.raises(RuntimeError, match="no checkpoint"):
        co.patch_params({"blocks": {}}, plan, [0])


def test_mid_recovery_state_clears_when_the_plan_lands(tmp_path):
    _, mt = _mgrs()
    _, _, pt = _params(*_mgrs())
    _save(mt, pt, tmp_path, tckpt)
    co = ElasticCoordinator(mt, ckpt_dir=str(tmp_path))
    co.fail_rank(0)
    assert co.recovering
    _observe((mt,), np.ones(E))
    plan = mt.maybe_replan(1)
    _drain_all(mt, co, plan, pt, TExec)
    assert not co.recovering


def test_churn_budget_exempts_recovery_layers():
    mj, mt = _mgrs(per_layer=True, max_changed_layers=1)
    loads = np.ones((3, E))
    loads[0, 1], loads[1, 3], loads[2, 5] = 60.0, 30.0, 20.0
    for m in (mj, mt):
        m.observe(np.stack([np.stack([loads[l], np.zeros(E)])
                            for l in range(3)]))
        m.must_layers = {2}                 # layer 2 carries lost experts
        m.request_replan()
    pj, pt = mj.maybe_replan(1), mt.maybe_replan(1)
    tm.plan_equal(pj, pt)
    changed = set(mt.plan_layers(pt))
    assert 2 in changed and len(changed) <= 2


def test_event_replan_bypasses_cadence_and_gain():
    mj, mt = _mgrs(replan_every=1000, min_gain=0.9)
    _observe((mj, mt), np.ones(E) + np.arange(E) * 0.01)
    assert mj.maybe_replan(7) is None and mt.maybe_replan(7) is None
    for m in (mj, mt):
        m.request_replan()
    pj, pt = mj.maybe_replan(8), mt.maybe_replan(8)
    assert pt is not None
    tm.plan_equal(pj, pt)
    mt.abort()
    assert mt.maybe_replan(9) is None           # the request was consumed


def test_lost_token_count_per_layer_and_shared():
    mj, mt = _mgrs(per_layer=True, n_layers=2)
    es = np.zeros((2, 2, E))
    es[0, 0, 3], es[1, 0, 3], es[1, 0, 6] = 5.0, 7.0, 2.0
    for lost, (a, b) in (({1: np.array([3, 6])}, _mgrs(True, 2)),
                         ({0: np.array([3])}, _mgrs())):
        cj, ct = JCo(a), ElasticCoordinator(b)
        assert ct.lost_token_count(es) == 0.0
        cj.lost, ct.lost = dict(lost), dict(lost)
        assert ct.lost_token_count(es) == cj.lost_token_count(es)
    assert ct.lost_token_count(es) == pytest.approx(12.0)


# --------------------------------------------------------------------------
# a recovery patch that fails part-way
# --------------------------------------------------------------------------
def test_failed_patch_rolls_the_landed_blocks_back(tmp_path):
    """The patch raises after the gather landed: the plan is aborted and
    the landed blocks go back by ``undo``, so every routable slot of the
    old tables holds what it held before."""
    _, mt = _mgrs(per_layer=True, n_layers=2)
    _, _, pt = _params(*_mgrs(per_layer=True, n_layers=2))
    _save(mt, pt, tmp_path, tckpt)
    co = ElasticCoordinator(mt, ckpt_dir=str(tmp_path))
    pt = co.fail_rank(0, pt)
    before = {k: pt["blocks"]["layer0"]["moe"][k].clone()
              for k in MOE_WEIGHT_KEYS}
    old_sets = list(mt.rsets)
    _observe((mt,), np.ones(E))
    plan = mt.maybe_replan(1)
    assert plan is not None

    def broken(params, plan_, layers):
        co.patch_params(params, plan_, layers)
        raise OSError("checkpoint read failed")

    ex = TExec(mt, plan, bytes_per_iter=1 << 30,
               priority_layers=co.recovery_layers(plan), patch_fn=broken,
               undo=trm.diff_layers(plan.new_sets, mt.rsets))
    with pytest.raises(OSError, match="checkpoint read failed"):
        ex.drain(pt)
    assert mt.in_flight is None and not ex.draining
    assert co.recovering                      # nothing committed
    for l, rs in enumerate(mt.rsets):
        assert np.array_equal(rs.rep_pos, old_sets[l].rep_pos)
        owner = rs.slot_owner
        for k in MOE_WEIGHT_KEYS:
            w = pt["blocks"]["layer0"]["moe"][k][l]
            for slot in np.flatnonzero(owner >= 0):
                if slot // SPR == 0:           # the dead rank's slots
                    continue
                assert torch.equal(w[slot], before[k][l, slot]), (l, slot)


def test_engine_sync_patch_failure_aborts_and_rolls_back(tmp_path,
                                                        monkeypatch):
    """The synchronous path: a failing recovery patch aborts the staged
    plan, takes the landed blocks back, and re-raises."""
    run = _elastic_engine(tmp_path, migrate_async=False)
    eng, co, mgr = run["eng"], run["co"], run["mgr"]
    eng.save_checkpoint(str(tmp_path / "ck"), 0)
    eng.fail_rank(2)
    assert co.recovering
    monkeypatch.setattr(co, "patch_params", lambda *a: (_ for _ in ()).throw(
        OSError("read failed")))
    tables = [np.asarray(a).copy() for a in mgr.device_tables()]
    mgr.observe(np.ones((mgr.n_tables, 2, E)))
    with pytest.raises(OSError, match="read failed"):
        eng._maybe_migrate()
    assert mgr.in_flight is None and co.recovering
    for a, b in zip(tables, mgr.device_tables()):
        assert np.array_equal(a, np.asarray(b))


def _elastic_engine(tmp_path, **kw):
    _, cfg, _, pnum = tm.model()
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.engine import Engine
    mgr = TRM(cfg, tm.TRCfg(replan_every=4, warmup_iters=2, min_gain=0.0,
                            per_layer=True, spare_per_rank=1,
                            max_replicas=2), EP)
    co = ElasticCoordinator(mgr, ckpt_dir=str(tmp_path / "ck"))
    eng = Engine(cfg, texpand(params_from_numpy(pnum, "cpu"), mgr.rsets),
                 tm.TCfg(gate_gamma=4), max_slots=2, max_len=32,
                 placement=mgr, elastic=co, device="cpu", **kw)
    return dict(eng=eng, co=co, mgr=mgr)


def test_engine_refuses_elastic_without_its_manager(tmp_path):
    run = _elastic_engine(tmp_path)
    other = TRM(run["eng"].cfg, tm.TRCfg(per_layer=True), EP)
    from repro_torch.serving.engine import Engine
    with pytest.raises(ValueError, match="wrap this engine's manager"):
        Engine(run["eng"].cfg, run["eng"].params, tm.TCfg(),
               placement=other, elastic=run["co"], device="cpu")
    with pytest.raises(RuntimeError, match="ElasticCoordinator"):
        Engine(run["eng"].cfg, run["eng"].params, tm.TCfg(),
               placement=run["mgr"], device="cpu").fail_rank(0)


# --------------------------------------------------------------------------
# the serving arm: scripted kill and rejoin in virtual time
# --------------------------------------------------------------------------
def test_engine_kill_rejoin_arm_matches_reference(tmp_path):
    """A kill before the first cadence replan (rank 2's experts are
    singletons, so a real degraded window opens) and a rejoin, through
    both engines: tokens, every IterStats field (``n_unroutable`` and
    ``lost_tokens`` included), the tables after every iteration, the
    coordinator's events, telemetry availability and recovery seconds, and
    the checkpoint refusal mid-recovery."""
    cos = {}
    refusals = {}

    def extra(mj, mt, clock_j, clock_t, tel_j, tel_t):
        for name, mgr, clock, tel, cls, fi in (
                ("ref", mj, clock_j, tel_j, JCo, JFI),
                ("port", mt, clock_t, tel_t, ElasticCoordinator,
                 FaultInjector)):
            cos[name] = cls(mgr, ckpt_dir=str(tmp_path / name), clock=clock,
                            telemetry=tel)
        return ({"elastic": cos["ref"],
                 "fault_injector": JFI([(3, "fail", 2), (14, "rejoin", 2)])},
                {"elastic": cos["port"],
                 "fault_injector": FaultInjector([(3, "fail", 2),
                                                  (14, "rejoin", 2)])})

    def before(eng_j, eng_t):
        # the re-materialization source, written before the kill
        eng_j.save_checkpoint(str(tmp_path / "ref"), 0)
        eng_t.save_checkpoint(str(tmp_path / "port"), 0)

    def after_step(eng):
        name = "port" if isinstance(eng, tm.TEngine) else "ref"
        if cos[name].recovering and name not in refusals:
            with pytest.raises(RuntimeError, match="draining|mid-recovery"):
                eng.save_checkpoint(str(tmp_path / name), 1)
            refusals[name] = eng._it

    run = tm.run_arm("replicate/L/async", extra=extra, before=before,
                     after_step=after_step, n_req=10)
    tm.assert_streams_equal(run)
    assert refusals["port"] == refusals["ref"]
    co_j, co_t = cos["ref"], cos["port"]
    assert _events(co_t) == _events(co_j)
    assert [e["kind"] for e in co_t.events][:2] == ["fail", "recovered"]
    assert any(s.n_unroutable > 0 for s in run.eng_t.stats)
    assert any(s.lost_tokens > 0 for s in run.eng_t.stats)
    sj, st = run.tel_j.summary(), run.tel_t.summary()
    for k in ("availability", "degraded_iters", "n_recoveries",
              "recovery_s", "lost_tokens_total"):
        if k in sj:
            assert st[k] == sj[k], k
    assert run.tel_t.degraded_iters >= 1 and run.tel_t.availability < 1.0
    assert st["recovery_s"] is not None
    assert run.eng_t._elastic.manager.rank_alive.all()
    assert co_t.state in (STATE_HEALTHY, STATE_WARMING)

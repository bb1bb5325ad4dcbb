"""The port's replan-decision audit log against the reference's: both
managers, shared and per-layer, record one verdict per ``maybe_replan``
call, equal to the reference's records on the same seeded stats stream;
a vetoing cost gate's rejection is priced alike; the JSONL export round
trips (mirrors tests/test_obs.py's audit tests)."""
import numpy as np
import pytest

import _torch_managers as tm
from repro.obs import ReplanAudit as JAudit
from repro.placement import PlacementManager as JPM
from repro.replication import ReplicaManager as JRM
from repro_torch.obs import ReplanAudit
from repro_torch.placement import PlacementManager as TPM
from repro_torch.replication import ReplicaManager as TRM

SKEW = [10.0, 8, 1, 1, 1, 1, 1, 1]
FLAT = [4.0] * 8
KINDS = {"placement": (JPM, TPM, tm.JPCfg, tm.TPCfg),
         "replication": (JRM, TRM, tm.JRCfg, tm.TRCfg)}


def _skew_stats(rows):
    es = np.zeros((len(rows), 2, 8))
    es[:, 0] = np.asarray(rows)
    return es


def _audited(kind, per_layer, cost_gate=None, **kw):
    jcls, tcls, jcfg, tcfg = KINDS[kind]
    cfg = dict(dict(replan_every=2, warmup_iters=3, min_gain=0.0,
                    per_layer=per_layer), **kw)
    out = []
    for cls, ccls, audit in ((jcls, jcfg, JAudit), (tcls, tcfg,
                                                    ReplanAudit)):
        mgr = cls.from_geometry(8, ccls(**cfg), 4, bytes_per_expert=7,
                                n_layers=3 if per_layer else 1,
                                cost_gate=cost_gate)
        mgr.audit = audit()
        out.append(mgr)
    return out


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("per_layer", [False, True])
def test_audit_one_event_per_maybe_replan_equals_reference(kind, per_layer):
    mj, mt = _audited(kind, per_layer)
    rng = np.random.default_rng(3)
    n_calls = 0
    for it in range(1, 13):
        rows = [SKEW, FLAT, SKEW[::-1]] if per_layer else [SKEW]
        es = _skew_stats(rows) * rng.integers(1, 4)
        for m in (mj, mt):
            m.observe(es)
        pj, pt = mj.maybe_replan(it), mt.maybe_replan(it)
        tm.plan_equal(pj, pt)
        n_calls += 1
        if pj is not None:
            if it % 4 == 0:                # an aborted plan, too
                mj.abort()
                mt.abort()
            else:
                mj.commit(pj)
                mt.commit(pt)
    assert mt.audit.events == mj.audit.events
    assert len(mt.audit) == n_calls
    assert [e["seq"] for e in mt.audit.events] == list(range(n_calls))
    assert mt.audit.query(it=1)[0]["verdict"] == "warmup"
    assert {e["it"] for e in mt.audit.cadence_hits()} == \
        {e["it"] for e in mj.audit.cadence_hits()} == {4, 6, 8, 10, 12}
    assert mt.audit.counts() == mj.audit.counts()
    assert mt.audit.counts("regime") == mj.audit.counts("regime")
    assert mt.audit.query(verdict="staged")


def test_audit_must_plan_after_event_equals_reference():
    """An event-triggered (elastic) replan is recorded as a must-plan."""
    mj, mt = _audited("replication", True, max_changed_layers=1)
    for m in (mj, mt):
        m.observe(_skew_stats([SKEW, FLAT, SKEW[::-1]]))
        m.must_layers = {2}
        m.request_replan()
    tm.plan_equal(mj.maybe_replan(1), mt.maybe_replan(1))
    assert mt.audit.events == mj.audit.events
    assert mt.audit.events[-1].get("must") is True


def test_audit_cost_gate_rejection_is_priced():
    class VetoGate:
        def accept(self, old, new, moved):
            return False

        def accept_layers(self, old, new, moved):
            return False

    mj, mt = _audited("placement", False, cost_gate=VetoGate(),
                      warmup_iters=1)
    for m in (mj, mt):
        m.observe(_skew_stats([SKEW]))
        assert m.maybe_replan(2) is None
    (ev,) = mt.audit.query(verdict="cost-gate")
    assert ev == mj.audit.query(verdict="cost-gate")[0]
    assert ev["migration_bytes"] > 0 and "pred_gain" in ev


def test_audit_jsonl_roundtrip_both_ways(tmp_path):
    for writer, reader in ((ReplanAudit, JAudit), (JAudit, ReplanAudit)):
        audit = writer()
        audit.record(it=1, manager="placement", verdict="warmup")
        audit.record(it=2, manager="placement", verdict="staged",
                     regime="mixed", pred_gain=0.5, migration_bytes=100,
                     dropped=None)                     # None fields dropped
        p = tmp_path / f"{writer.__module__}.jsonl"
        audit.to_jsonl(str(p))
        back = reader.load_jsonl(str(p))
        assert back == audit.events
        assert "dropped" not in back[1]


def test_audit_off_by_default():
    _, tcls, _, tcfg = KINDS["placement"]
    mgr = tcls.from_geometry(8, tcfg(replan_every=2, warmup_iters=1,
                                     min_gain=0.0), 4, bytes_per_expert=7)
    assert mgr.audit is None
    mgr.observe(_skew_stats([SKEW]))
    assert mgr.maybe_replan(2) is not None             # planning unaffected

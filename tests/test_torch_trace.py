"""The port's span tracer against the reference's: the same spans, instants
and args on one migrating serving run in virtual time (the async placement
arm), a Perfetto-loadable export, and a disabled tracer that records
nothing."""
import json

import pytest

import _torch_managers as tm
from _torch_managers import one_torch_thread  # noqa: F401
from repro.obs.trace import validate_chrome_trace as j_validate
from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.obs.trace import load_trace, validate_chrome_trace

# the executor's measured gather: its duration and wall_s are wall seconds
WALL_ARGS = {"wall_s"}


@pytest.fixture(scope="module")
def traced():
    return tm.run_arm("placement/L/async", trace=True)


def test_migration_run_spans_equal_reference(traced):
    ej, et = traced.eng_j.tracer._events, traced.eng_t.tracer._events
    assert [e[:3] for e in ej] == [e[:3] for e in et]
    for a, b in zip(ej, et):
        ph, name, cat, t0a, dura, argsa = a
        _, _, _, t0b, durb, argsb = b
        assert t0a == t0b, name
        if name == "migration.apply":
            assert set(argsa) == set(argsb)
            assert {k: v for k, v in argsa.items() if k not in WALL_ARGS} \
                == {k: v for k, v in argsb.items() if k not in WALL_ARGS}
            continue
        assert dura == durb, name
        assert argsa == argsb, name
    names = {e[1] for e in et}
    for n in ("iter", "admit", "forward.chunk", "forward.decode",
              "dispatch.policy", "replan.placement", "migration.drain",
              "migration.apply", "table.commit"):
        assert n in names, n
    # drain spans reconcile with the stall + hidden telemetry totals
    drains = [e for e in et if e[1] == "migration.drain"]
    assert sum(e[4] for e in drains) == pytest.approx(
        traced.eng_t.migration_stall_s + traced.eng_t.migration_hidden_s)


def test_chrome_export_loads(traced, tmp_path):
    path = traced.eng_t.tracer.write(str(tmp_path / "t.json"),
                                     metadata={"arm": "placement/L/async"})
    obj = load_trace(path)
    assert len(validate_chrome_trace(obj)) == len(j_validate(json.loads(
        json.dumps(traced.eng_j.tracer.to_chrome()))))
    assert obj["metadata"]["arm"] == "placement/L/async"


def test_null_tracer_records_nothing():
    assert not NULL_TRACER.enabled
    with NULL_TRACER.span("x") as sp:
        sp.set(a=1)
    NULL_TRACER.instant("y")
    NULL_TRACER.complete("z", 0.0, 1.0)
    t = Tracer(clock=lambda: 2.0)
    with t.span("outer") as sp:
        sp.set(k=3)
        t.instant("mark", args={"n": 1})
    assert [e[:2] for e in t._events] == [("i", "mark"), ("X", "outer")]
    assert len(t) == 2

"""The port's asynchronous migration against the reference's: the executor's
chunk queue, budget packing, priority layers, per-layer commits and
cancel; its in-place drains against the reference's functional ones; a
batch that fails part-way; the ``placement/L/async`` and
``replicate/L/async`` serving arms; and the mid-flight checkpoint refusal
(mirrors tests/test_async_migrate.py, parity where the reference asserts
a property)."""
import jax
import numpy as np
import pytest
import torch

import _torch_managers as tm
from _torch_managers import one_torch_thread  # noqa: F401
from repro.placement import migrate as jpm
from repro.serving.async_migrate import MigrationExecutor as JExec
from repro_torch.placement import migrate as tpm
from repro_torch.serving.async_migrate import MigrationExecutor as TExec
from repro_torch.serving.async_migrate import SlabChunk

SKEW = [10.0, 8, 1, 1, 1, 1, 1, 1]
FLAT = [4.0] * 8


def _skew_stats(rows):
    es = np.zeros((len(rows), 2, 8))
    es[:, 0] = np.asarray(rows)
    return es


def _mgrs(kind="placement", n_layers=3, bpe=100, **kw):
    cfg = dict(replan_every=2, warmup_iters=1, min_gain=0.0, per_layer=True,
               **kw)
    if kind == "placement":
        from repro.placement import PlacementManager as J
        from repro_torch.placement import PlacementManager as T
        return (J.from_geometry(8, tm.JPCfg(**cfg), 4, bpe, n_layers=n_layers),
                T.from_geometry(8, tm.TPCfg(**cfg), 4, bpe, n_layers=n_layers))
    from repro.replication import ReplicaManager as J
    from repro_torch.replication import ReplicaManager as T
    return (J.from_geometry(8, tm.JRCfg(**cfg), 4, bpe, n_layers=n_layers),
            T.from_geometry(8, tm.TRCfg(**cfg), 4, bpe, n_layers=n_layers))


def _params(n_layers=3, n_slots=8, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_layers, n_slots, 4, 6)).astype(np.float32)
    return {"blocks": {"layer0": {"moe": {
        "router": np.zeros((4, 8), np.float32), "w_gate": w, "w_up": w + 1,
        "w_down": np.ascontiguousarray(np.swapaxes(w, 2, 3))}}}}


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _same(ref, port):
    for k in ("w_gate", "w_up", "w_down"):
        assert np.array_equal(np.asarray(ref["blocks"]["layer0"]["moe"][k]),
                              port["blocks"]["layer0"]["moe"][k].numpy()), k


def _staged(kind="placement", rows=(SKEW, FLAT, SKEW[::-1]), **kw):
    mj, mt = _mgrs(kind, n_layers=len(rows), **kw)
    for m in (mj, mt):
        m.observe(_skew_stats(list(rows)))
    pj, pt = mj.maybe_replan(2), mt.maybe_replan(2)
    tm.plan_equal(pj, pt)
    return mj, mt, pj, pt


@pytest.mark.parametrize("kind", ["placement", "replication"])
@pytest.mark.parametrize("budget", [1, 150, 10 ** 9])
def test_executor_drains_match_reference(kind, budget):
    """Chunk queue, budget packing, per-layer commits and the landed
    weights equal the reference executor's, drain by drain."""
    mj, mt, pj, pt = _staged(kind)
    n_slots = 8 if kind == "placement" else mt.n_slots
    params = _params(n_slots=n_slots)
    ej, et = JExec(mj, pj, bytes_per_iter=budget), \
        TExec(mt, pt, bytes_per_iter=budget)
    assert [(c.layer, c.nbytes) for c in ej.queue] == \
        [(c.layer, c.nbytes) for c in et.queue]
    assert all(isinstance(c, SlabChunk) for c in et.queue)
    assert et.total_bytes == ej.total_bytes
    out_j, out_t = params, _torch(params)
    while ej.draining:
        out_j, rj = ej.drain(out_j)
        out_t, rt = et.drain(out_t)
        assert (rj.layers, rj.nbytes, rj.budget_bytes, rj.done,
                rj.excess_bytes) == (rt.layers, rt.nbytes, rt.budget_bytes,
                                     rt.done, rt.excess_bytes)
        _same(out_j, out_t)
        tm.tables_equal(mj, mt)
        assert mt._pending_remaining == mj._pending_remaining
    assert not et.draining and mt.in_flight is None
    tm.state_equal(mj, mt)
    assert mt.bandwidth.calibrated             # timed applies observed


def test_executor_budget_from_measured_bandwidth():
    mj, mt, pj, pt = _staged()
    ej, et = JExec(mj, pj), TExec(mt, pt)
    for iter_s in (None, 0.0, 1e-9, 2e-3):
        assert ej.budget_bytes(iter_s) == et.budget_bytes(iter_s)
    mt.bandwidth.observe(10 ** 6, 1.0)
    assert et.budget_bytes(1.0) == 10 ** 6


def test_executor_priority_layers_and_cancel():
    mj, mt, pj, pt = _staged()
    ej = JExec(mj, pj, bytes_per_iter=1, priority_layers=[2])
    et = TExec(mt, pt, bytes_per_iter=1, priority_layers=[2])
    assert [c.layer for c in et.queue] == [c.layer for c in ej.queue] \
        == [2, 0]
    out, rep = et.drain(_torch(_params()))
    assert rep.layers == [2] and mt._pending_remaining == {0}
    et.cancel()
    assert not et.draining and mt.in_flight is None
    assert np.array_equal(mt.tables[2].e2r, pt.new_tables[2].e2r)
    assert not np.array_equal(mt.tables[0].e2r, pt.new_tables[0].e2r)


@pytest.mark.parametrize("kind", ["placement", "replication"])
def test_apply_layers_union_equals_full_apply(kind):
    mj, mt, pj, pt = _staged(kind)
    n_slots = 8 if kind == "placement" else mt.n_slots
    params = _params(n_slots=n_slots, seed=4)
    want = jpm.apply_to_params(params, pj)
    out = _torch(params)
    for layer in reversed(mt.plan_layers(pt)):
        tpm.apply_layers_to_params(out, pt, [layer])
    _same(want, out)
    with pytest.raises(AssertionError):
        tpm.subset_plan(tpm.diff(tm.TPM.from_geometry(
            8, tm.TPCfg(), 4).table, tm.TPM.from_geometry(
            8, tm.TPCfg(), 4).table), [1])


@pytest.mark.parametrize("fail_at", [1, 2])
def test_drain_failure_keeps_tables_and_weights_consistent(monkeypatch,
                                                           fail_at):
    """A batch of two chunks whose second (or first) layer fails to gather:
    the batch's landed layer is taken back, the plan aborted; layers of
    earlier batches stay routable and in their new layout."""
    mj, mt, pj, pt = _staged(rows=(SKEW, SKEW[::-1], FLAT, SKEW))
    params = _params(n_layers=4)
    ex = TExec(mt, pt, bytes_per_iter=10 ** 9,
               undo=tpm.diff_layers(pt.new_tables, mt.tables))
    layers = mt.plan_layers(pt)
    assert len(layers) >= 2
    out = _torch(params)
    before = {k: v.clone() for k, v in out["blocks"]["layer0"]["moe"]
              .items()}
    orig, seen = tpm._gather_rows, []

    def boom(slabs, row):
        if (row != np.arange(row.shape[0])).any():
            seen.append(1)
            if len(seen) == fail_at:
                raise RuntimeError("simulated gather failure")
        return orig(slabs, row)

    monkeypatch.setattr(tpm, "_gather_rows", boom)
    with pytest.raises(RuntimeError, match="gather failure"):
        ex.drain(out)
    monkeypatch.undo()
    assert mt.in_flight is None and not ex.draining
    for l in range(4):
        assert np.array_equal(mt.tables[l].e2r, tm.TPM.from_geometry(
            8, tm.TPCfg(), 4).table.e2r)
    for k in ("w_gate", "w_up", "w_down"):
        assert torch.equal(out["blocks"]["layer0"]["moe"][k], before[k])


def test_drain_failed_undo_still_aborts_and_raises_the_gather_error(
        monkeypatch):
    """The batch's second layer fails to gather and the gather back of the
    first fails too: the plan is still aborted and the queue dropped, and
    the gather's own error is raised, with the failed undo noted on it."""
    mj, mt, pj, pt = _staged(rows=(SKEW, SKEW[::-1], FLAT, SKEW))
    ex = TExec(mt, pt, bytes_per_iter=10 ** 9,
               undo=tpm.diff_layers(pt.new_tables, mt.tables))
    out = _torch(_params(n_layers=4))
    orig, seen = tpm._gather_rows, []

    def boom(slabs, row):
        if (row != np.arange(row.shape[0])).any():
            seen.append(1)
            if len(seen) == 2:
                raise RuntimeError("simulated gather failure")
            if len(seen) > 2:
                raise RuntimeError("simulated undo failure")
        return orig(slabs, row)

    monkeypatch.setattr(tpm, "_gather_rows", boom)
    with pytest.raises(RuntimeError, match="gather failure") as info:
        ex.drain(out)
    assert len(seen) == 3
    assert any("landed block" in n and "undo failure" in n
               for n in getattr(info.value, "__notes__", []))
    assert mt.in_flight is None and not ex.draining


@pytest.mark.parametrize("arm", ["placement/L/async", "replicate/L/async"])
def test_engine_async_arm_matches_reference(arm):
    """Same tokens, IterStats (migration_s stall and migration_hidden_s
    split included), tables after every iteration, and commits."""
    # the capacity margin re-jits the reference's steps at every resize
    run = tm.run_arm(arm, n_req=4 if arm.startswith("replicate") else
                     tm.N_REQ)
    tm.assert_streams_equal(run)
    st = run.eng_t.stats
    assert any(s.migration_hidden_s > 0 for s in st)
    assert run.eng_t._placement.n_migrations > 0
    drains = [s for s in st if s.migration_bytes > 0]
    assert len(drains) > run.eng_t._placement.n_migrations   # chunked


def test_engine_async_mid_flight_checkpoint_refused(tmp_path):
    run = tm.run_arm("placement/L/async", n_req=2)
    eng, mgr = run.eng_t, run.eng_t._placement
    mgr.observe(_skew_stats([SKEW, SKEW[::-1], FLAT]))
    plan = mgr.maybe_replan(10 ** 6)
    if plan is None:
        pytest.fail("no plan to stage")
    eng._mig = TExec(mgr, plan, bytes_per_iter=1,
                     undo=eng._undo_plan(plan))
    eng._drain_migration()
    assert eng.migration_draining
    with pytest.raises(RuntimeError, match="drain_migrations"):
        eng.save_checkpoint(str(tmp_path), 1)
    with pytest.raises(RuntimeError, match="drain_migrations"):
        eng.load_checkpoint(str(tmp_path))
    eng.drain_migrations()
    assert not eng.migration_draining and mgr.in_flight is None
    eng.save_checkpoint(str(tmp_path), 1)


def test_engine_sync_wall_clock_records_measured_seconds():
    """Under a wall clock the synchronous path records the gather's
    measured seconds as the stall, and feeds them to the bandwidth EWMA."""
    cfg_j, cfg_t, _, pnum = tm.model()
    from repro_torch.convert import params_from_numpy
    from repro_torch.serving.scheduler import Request
    mt = tm.managers(cfg_j, cfg_t, "placement", replan_every=2,
                     warmup_iters=1, min_gain=0.0)[1]
    eng = tm.TEngine(cfg_t, params_from_numpy(pnum, "cpu"),
                     tm.TCfg(**tm.POLICY), placement=mt, device="cpu",
                     **tm.ENGINE)
    rng = np.random.default_rng(2)
    for uid in range(4):
        eng.submit(Request(uid=uid, tokens=rng.integers(
            0, cfg_t.vocab_size, 12).astype(np.int32),
            modality=rng.random(12) < 0.5, max_new_tokens=6))
    eng.run()
    assert mt.n_migrations > 0 and mt.bandwidth.calibrated
    moved = [s for s in eng.stats if s.migration_bytes > 0]
    assert moved and all(s.migration_s > 0 for s in moved)
    assert eng.migration_stall_s == pytest.approx(
        sum(s.migration_s for s in eng.stats))

"""The port's placement subsystem against the reference's: tables,
planners, predictor, diffs, the in-place slab gather, the placement-threaded
MoE layer, the manager on one seeded stats stream, and the placement arm
of the serving engine (mirrors tests/test_placement.py, parity where the
reference asserts a property)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_managers as tm
from _torch_managers import one_torch_thread  # noqa: F401
from benchmarks import costmodel as cm
from repro.configs import ReaLBConfig as JCfg
from repro.core import ep_moe as jmoe
from repro.placement import EWMAPredictor as JPred
from repro.placement import PlacementTable as JTable
from repro.placement import apply_to_params as japply
from repro.placement import diff as jdiff
from repro.placement import migrate as jmigrate
from repro.placement import planner as jplanner
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.core import ep_moe as tmoe
from repro_torch.placement import EWMAPredictor as TPred
from repro_torch.placement import PlacementTable as TTable
from repro_torch.placement import apply_to_params as tapply
from repro_torch.placement import diff as tdiff
from repro_torch.placement import migrate as tmigrate
from repro_torch.placement import planner as tplanner


def random_owner(e, seed):
    return np.random.default_rng(seed).permutation(e)


def tables(e, ep, seed):
    """The same random table in both packages."""
    owner = random_owner(e, seed)
    pos = np.empty(e, np.int64)
    pos[owner] = np.arange(e)
    e_loc = e // ep
    return (JTable(pos // e_loc, pos % e_loc, ep),
            TTable(pos // e_loc, pos % e_loc, ep))


def _loads(seed, e=16):
    rng = np.random.default_rng(seed)
    load = np.exp(rng.normal(0, 1.5, e))
    if seed % 3 == 0:                      # ties: equal loads break by index
        load = np.round(load)
    vis = load * rng.random(e)
    return load, vis


# --------------------------------------------------------------------------
# table
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_views_match_reference(seed):
    tj, tt = tables(16, 4, seed)
    assert np.array_equal(tj.pos, tt.pos)
    assert np.array_equal(tj.owner, tt.owner)
    assert tj.e_loc == tt.e_loc and tj.num_experts == tt.num_experts
    load = np.random.default_rng(seed).random(16)
    assert np.array_equal(tj.rank_loads(load), tt.rank_loads(load))
    e2r = np.random.default_rng(seed).permutation(np.arange(16) % 4)
    fj, ft = JTable.from_ranks(e2r, 4), TTable.from_ranks(e2r, 4)
    assert np.array_equal(fj.local_slot, ft.local_slot)
    ij, it = JTable.identity(16, 4), TTable.identity(16, 4)
    for a, b in zip(ij.as_tuple(), it.as_tuple()):
        assert np.array_equal(a, b) and a.dtype == b.dtype


def test_table_rejects_overfull_rank():
    for cls in (JTable, TTable):
        with pytest.raises(AssertionError):
            cls(np.zeros(8, np.int32), np.arange(8, dtype=np.int32), 4)


# --------------------------------------------------------------------------
# planners
# --------------------------------------------------------------------------
@pytest.mark.parametrize("planner", ["identity", "least_loaded",
                                     "modality_aware"])
@pytest.mark.parametrize("seed", range(6))
def test_planners_match_reference(planner, seed):
    load, vis = _loads(seed)
    pj = jplanner.plan_placement(planner, load, 4, vis=vis)
    pt = tplanner.plan_placement(planner, load, 4, vis=vis)
    assert np.array_equal(pj.e2r, pt.e2r)
    assert np.array_equal(pj.local_slot, pt.local_slot)


def test_plan_placement_dispatch_and_unknown():
    assert tplanner.PLANNERS == jplanner.PLANNERS
    with pytest.raises(ValueError):
        tplanner.plan_placement("nope", np.ones(8), 4)


# --------------------------------------------------------------------------
# predictor
# --------------------------------------------------------------------------
@pytest.mark.parametrize("halflife", [0.0, 3.0])
def test_predictor_matches_reference(halflife):
    pj, pt = JPred(8, alpha=0.3, decode_halflife=halflife), \
        TPred(8, alpha=0.3, decode_halflife=halflife)
    for es, _, dec in tm.stats_stream(12, 3, 8, seed=4):
        pj.observe(es[:, 0], es[:, 1], decode=dec)
        pt.observe(es[:, 0], es[:, 1], decode=dec)
        for regime in ("mixed", "decode"):
            for a, b in zip(pj.predict(regime), pt.predict(regime)):
                assert np.array_equal(a, b)
            for a, b in zip(pj.predict_layers(regime),
                            pt.predict_layers(regime)):
                assert np.array_equal(a, b)
    pj.observe(np.zeros((3, 8)))                   # ignored, not decayed
    pt.observe(np.zeros((3, 8)))
    sj, st = pj.state_dict(), pt.state_dict()
    assert sorted(sj) == sorted(st)
    for k in sj:
        assert np.array_equal(sj[k], st[k]), k
    fresh = TPred(8, decode_halflife=halflife)
    fresh.load_state_dict({k: np.asarray(v) for k, v in sj.items()})
    assert np.array_equal(fresh.predict()[0], pt.predict()[0])
    assert fresh.n_obs == pt.n_obs and fresh.alpha == pt.alpha


# --------------------------------------------------------------------------
# migration
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5])
def test_diff_matches_reference(seed):
    oj, ot = tables(16, 4, seed)
    nj, nt = tables(16, 4, seed + 1)
    pj, pt = jdiff(oj, nj, bytes_per_expert=7), tdiff(ot, nt,
                                                     bytes_per_expert=7)
    tm.plan_equal(pj, pt)
    assert pt.n_moved == pj.n_moved and pt.is_noop == pj.is_noop
    lj = jmigrate.diff_layers([oj, nj, oj], [nj, nj, nj], 5)
    lt = tmigrate.diff_layers([ot, nt, ot], [nt, nt, nt], 5)
    tm.plan_equal(lj, lt)
    assert np.array_equal(lj.changed_layers, lt.changed_layers)
    assert tdiff(ot, ot).is_noop


def _stacked(seed, n_blocks=3, e=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_blocks, e, 4, 6)).astype(dtype)
    return {"blocks": {"layer0": {"moe": {
        "router": rng.normal(size=(4, e)).astype(np.float32),
        "w_gate": w, "w_up": w * 2 - 1,
        "w_down": np.ascontiguousarray(np.swapaxes(w, 2, 3))}}}}


def _as_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _same_weights(ref, port):
    for k in ("router", "w_gate", "w_up", "w_down"):
        a = np.asarray(ref["blocks"]["layer0"]["moe"][k])
        b = port["blocks"]["layer0"]["moe"][k].numpy()
        assert a.shape == b.shape and np.array_equal(
            a.view(np.uint32), b.view(np.uint32)), k


@pytest.mark.parametrize("kind", ["shared", "per_layer", "union"])
def test_apply_to_params_matches_reference(kind):
    """The in-place gather gives the reference's bytes: a shared plan, a
    per-layer plan, and the union of one-layer applies of it."""
    params = _stacked(0)
    olds = [tables(8, 4, s) for s in (10, 11, 12)]
    news = [tables(8, 4, s) for s in (20, 11, 22)]
    if kind == "shared":
        pj, pt = jdiff(olds[0][0], news[0][0]), tdiff(olds[0][1], news[0][1])
    else:
        pj = jmigrate.diff_layers([o[0] for o in olds], [n[0] for n in news])
        pt = tmigrate.diff_layers([o[1] for o in olds], [n[1] for n in news])
    want = japply(params, pj)
    got = _as_torch(params)
    router = got["blocks"]["layer0"]["moe"]["router"]
    if kind == "union":
        for layer in pt.changed_layers:
            tmigrate.apply_layers_to_params(got, pt, [layer])
    else:
        assert tapply(got, pt) is got
    _same_weights(want, got)
    assert got["blocks"]["layer0"]["moe"]["router"] is router


def test_failed_gather_undo_restores_the_old_layout():
    """A block's slabs land together; the inverse diff takes landed blocks
    back, bitwise."""
    params = _as_torch(_stacked(1))
    before = {k: v.clone() for k, v in params["blocks"]["layer0"]["moe"]
              .items()}
    old, new = tables(8, 4, 30)[1], tables(8, 4, 31)[1]
    landed = []
    tapply(params, tdiff(old, new), landed)
    assert landed == [("blocks", "layer0", b) for b in range(3)]
    tmigrate.undo_blocks(params, tdiff(new, old), landed[:2])
    moe = params["blocks"]["layer0"]["moe"]
    for k in ("w_gate", "w_up", "w_down"):
        assert torch.equal(moe[k][:2], before[k][:2])
        assert not torch.equal(moe[k][2], before[k][2])


def test_bandwidth_ewma_matches_reference():
    bj, bt = jmigrate.MigrationBandwidth(), tmigrate.MigrationBandwidth()
    for nbytes, secs in ((10 ** 9, 0.02), (0, 1.0), (5 * 10 ** 8, 0.004),
                         (10 ** 6, 0.0)):
        bj.observe(nbytes, secs)
        bt.observe(nbytes, secs)
        assert float(bj) == float(bt) and bj.n_obs == bt.n_obs
        assert bj.seconds(12345) == bt.seconds(12345)
    bt.reset()
    assert float(bt) == tm.TPCfg().migration_bw and not bt.calibrated


# --------------------------------------------------------------------------
# MoE layer with a table
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_setup():
    cfg_j, cfg_t, _, _ = tm.model()
    rng = np.random.default_rng(3)
    d, e, f = cfg_t.d_model, cfg_t.moe.num_experts, cfg_t.moe.d_ff
    p = {"router": rng.normal(size=(d, e)).astype(np.float32) * 0.2,
         "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) / d ** .5,
         "w_up": rng.normal(size=(e, d, f)).astype(np.float32) / d ** .5,
         "w_down": rng.normal(size=(e, f, d)).astype(np.float32) / f ** .5}
    x = (rng.normal(size=(2, 16, d)) * 0.5).astype(np.float32)
    mod = rng.random((2, 16)) < 0.6
    return cfg_j, cfg_t, p, x, mod


@pytest.mark.parametrize("mode", ["dispatch", "broadcast"])
def test_identity_table_bitwise_equal(moe_setup, mode):
    _, cfg, p, x, mod = moe_setup
    rcfg = TCfg(gate_gamma=10 ** 9)
    m = torch.full((1, 4), 0.9)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    ident = tmoe.identity_placement(cfg.moe.num_experts, 4)
    y0, m0, a0 = tmoe.ep_moe_forward(pt, torch.from_numpy(x), cfg, rcfg, m,
                                     torch.from_numpy(mod), mode=mode)
    y1, m1, a1 = tmoe.ep_moe_forward(pt, torch.from_numpy(x), cfg, rcfg, m,
                                     torch.from_numpy(mod), mode=mode,
                                     placement=ident)
    assert torch.equal(y0, y1) and torch.equal(m0, m1)
    for k in ("load_d", "vis_d", "drop_frac", "lb_loss", "slot_load"):
        assert torch.equal(a0[k], a1[k]), k


@pytest.mark.parametrize("mode", ["dispatch", "broadcast"])
def test_permuted_table_matches_reference(moe_setup, mode):
    """Permuted slabs under a permuted table: routing stats exact against
    the reference, outputs within the kernel-test tolerance."""
    cfg_j, cfg_t, p, x, mod = moe_setup
    kw = dict(gate_gamma=8, md_init=0.0)
    tj, tt = tables(cfg_t.moe.num_experts, 4, seed=2)
    perm = tt.owner
    p_perm = dict(p, w_gate=p["w_gate"][perm], w_up=p["w_up"][perm],
                  w_down=p["w_down"][perm])
    m = np.full((1, 4), 0.0, np.float32)
    yj, mj, aj = jmoe.ep_moe_forward(
        {k: jnp.asarray(v) for k, v in p_perm.items()}, jnp.asarray(x),
        cfg_j, JCfg(**kw), jnp.asarray(m), jnp.asarray(mod), mode=mode,
        placement=(jnp.asarray(tj.e2r), jnp.asarray(tj.local_slot)))
    yt, mt, at = tmoe.ep_moe_forward(
        {k: torch.from_numpy(v) for k, v in p_perm.items()},
        torch.from_numpy(x), cfg_t, TCfg(**kw), torch.from_numpy(m),
        torch.from_numpy(mod), mode=mode,
        placement=(torch.from_numpy(tt.e2r), torch.from_numpy(tt.local_slot)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-4)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    for k in ("load_d", "vis_d", "expert_load", "expert_vis", "slot_load",
              "fp4_ranks"):
        assert np.array_equal(at[k].numpy(), np.asarray(aj[k])), k


# --------------------------------------------------------------------------
# manager
# --------------------------------------------------------------------------
MANAGER_CASES = {
    "least_loaded": dict(planner="least_loaded", replan_every=3,
                         warmup_iters=2),
    "modality_aware": dict(planner="modality_aware", replan_every=2,
                           warmup_iters=1, min_gain=0.0),
    "decode_cadence": dict(planner="least_loaded", replan_every=0,
                           warmup_iters=1, decode_halflife=2.0,
                           decode_replan_every=2, min_gain=0.0),
    "identity": dict(planner="identity", replan_every=2, warmup_iters=1),
    "cost_gate": dict(planner="least_loaded", replan_every=2,
                      warmup_iters=1, min_gain=0.0),
    "per_layer_churn": dict(planner="least_loaded", replan_every=2,
                            warmup_iters=1, min_gain=0.0, per_layer=True,
                            max_changed_layers=1),
}


def drive_managers(mj, mt, n_iters=20, seed=0, abort_every=5):
    """One seeded stats stream through both managers: observe, replan at
    the cadence, and commit the staged plan (every ``abort_every``-th plan
    aborted instead) — equal plans, tables and state at every step."""
    n_blocks = mj.n_tables if mj.per_layer else 3
    n_staged = 0
    for it, (es, ss, dec) in enumerate(
            tm.stats_stream(n_iters, n_blocks, mj.num_experts,
                            getattr(mj, "n_slots", None), seed=seed), 1):
        mj.observe(es, decode=dec)
        mt.observe(es, decode=dec)
        if hasattr(mj, "observe_slots"):
            mj.observe_slots(ss)
            mt.observe_slots(ss)
        pj, pt = mj.maybe_replan(it), mt.maybe_replan(it)
        tm.plan_equal(pj, pt)
        assert mj._verdict == mt._verdict
        assert mj._verdict_fields == mt._verdict_fields
        if pj is not None:
            assert mt.in_flight is pt and mt.maybe_replan(it + 1) is None
            mj.maybe_replan(it + 1)
            assert mt.plan_bytes(pt) == mj.plan_bytes(pj)
            assert mt.plan_layers(pt) == mj.plan_layers(pj)
            n_staged += 1
            if n_staged % abort_every == 0:
                mj.abort()
                mt.abort()
            else:
                mj.commit(pj)
                mt.commit(pt)
        tm.tables_equal(mj, mt)
        tm.state_equal(mj, mt)
        for regime in ("mixed", "decode"):
            a, b = mj.predicted_rank_loads(regime), \
                mt.predicted_rank_loads(regime)
            assert (a is None) == (b is None)
            assert a is None or np.array_equal(a, b)
        assert np.array_equal(mj.rank_heatmap(es, ss), mt.rank_heatmap(es, ss))
    return n_staged


@pytest.mark.parametrize("case", list(MANAGER_CASES))
def test_manager_stream_matches_reference(case):
    cfg_j, cfg_t, _, _ = tm.model()
    gates = (None, None)
    if case == "cost_gate":
        gates = tuple(cm.ReplanCostGate(cm.KIMI_VL, 4, horizon_iters=8,
                                        tokens_per_iter=512.0)
                      for _ in range(2))
    mj, mt = tm.managers(cfg_j, cfg_t, "placement", cost_gates=gates,
                         **MANAGER_CASES[case])
    if case == "cost_gate":
        assert mt.cost_gate.bandwidth is mt.bandwidth
    n = drive_managers(mj, mt)
    assert mt.n_migrations == mj.n_migrations
    if case == "identity":
        assert n == 0
    elif case != "cost_gate":
        assert n > 0
    assert mt.migration_seconds(10 ** 9) == mj.migration_seconds(10 ** 9)


def test_manager_from_geometry_and_reset():
    pc = dict(planner="least_loaded", replan_every=1, warmup_iters=1,
              per_layer=True)
    from repro.placement import PlacementManager as JPM
    from repro_torch.placement import PlacementManager as TPM
    mj = JPM.from_geometry(16, tm.JPCfg(**pc), 4, 100, n_layers=3)
    mt = TPM.from_geometry(16, tm.TPCfg(**pc), 4, 100, n_layers=3)
    drive_managers(mj, mt, n_iters=6, seed=2)
    mt.reset()
    assert mt.n_migrations == 0 and all(
        np.array_equal(t.e2r, TTable.identity(16, 4).e2r)
        for t in mt.tables)


def test_manager_state_roundtrip_and_shared_mismatch():
    cfg_j, cfg_t, _, _ = tm.model()
    mj, mt = tm.managers(cfg_j, cfg_t, "placement", per_layer=True,
                         replan_every=2, warmup_iters=1, min_gain=0.0)
    drive_managers(mj, mt, n_iters=8, seed=3)
    fj, ft = tm.managers(cfg_j, cfg_t, "placement", per_layer=True)
    fj.load_state_dict(mj.state_dict())
    ft.load_state_dict(mj.state_dict())           # the reference's state
    tm.state_equal(fj, ft)
    tm.tables_equal(mj, ft)
    shared = tm.managers(cfg_j, cfg_t, "placement")[1]
    with pytest.raises(ValueError, match="not interchangeable"):
        shared.load_state_dict(mt.state_dict())


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------
def test_engine_live_migration_matches_reference():
    """The placement arm: same tokens, IterStats, routable tables after
    every iteration, commits and prediction windows."""
    run = tm.run_arm("placement")
    tm.assert_streams_equal(run)
    assert run.eng_t._placement.n_migrations > 0
    assert sum(s.migration_bytes for s in run.eng_t.stats) > 0


def test_engine_refuses_mismatched_topology():
    cfg_j, cfg_t, _, pnum = tm.model()
    mt = tm.managers(cfg_j, cfg_t, "placement")[1]
    from repro_torch.convert import params_from_numpy
    with pytest.raises(ValueError, match="virtual_ep"):
        tm.TEngine(cfg_t, params_from_numpy(pnum, "cpu"), TCfg(),
                   placement=mt, virtual_ep=2, device="cpu")
    with pytest.raises(NotImplementedError, match="elastic"):
        tm.TEngine(cfg_t, params_from_numpy(pnum, "cpu"), TCfg(),
                   placement=mt, elastic=object(), device="cpu")


def test_engine_identity_placement_matches_baseline():
    """With the identity planner the manager never migrates, and the
    engine serves exactly what a manager-free engine serves."""
    cfg_j, cfg_t, _, pnum = tm.model()
    from repro_torch.convert import params_from_numpy
    from repro_torch.workloads import arrivals as ta
    mt = tm.managers(cfg_j, cfg_t, "placement", planner="identity")[1]
    outs = []
    for mgr in (None, mt):
        eng = tm.TEngine(cfg_t, params_from_numpy(pnum, "cpu"),
                         TCfg(**tm.POLICY), placement=mgr,
                         clock=ta.VirtualClock(), device="cpu", **tm.ENGINE)
        rng = np.random.default_rng(0)
        from repro_torch.serving.scheduler import Request
        for uid in range(4):
            n = int(rng.integers(4, 14))
            eng.submit(Request(uid=uid, tokens=rng.integers(
                0, cfg_t.vocab_size, n).astype(np.int32),
                modality=rng.random(n) < 0.5, max_new_tokens=4))
        done = eng.run()
        outs.append(({r.uid: r.generated for r in done},
                     [dataclasses.astuple(s) for s in eng.stats]))
    assert outs[0] == outs[1] and mt.n_migrations == 0

"""The port's replication subsystem against the reference's: replica sets,
the planner, diffs, the slot expansion, the weighted token split in the MoE
layer, the replica manager on one seeded stats stream, and the replicate
arm of the serving engine, including a gather that fails part-way (mirrors
tests/test_replication.py, parity where the reference asserts a
property)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_managers as tm
from _torch_managers import one_torch_thread  # noqa: F401
from repro.configs import ReaLBConfig as JCfg
from repro.core import ep_moe as jmoe
from repro.placement import PlacementTable as JTable
from repro.placement import migrate as jpmigrate
from repro.replication import ReplicaSet as JSet
from repro.replication import expand_moe_params as jexpand
from repro.replication import migrate as jmigrate
from repro.replication import planner as jplanner
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.convert import params_from_numpy
from repro_torch.core import ep_moe as tmoe
from repro_torch.placement import PlacementTable as TTable
from repro_torch.placement import migrate as tpmigrate
from repro_torch.replication import ReplicaSet as TSet
from repro_torch.replication import expand_moe_params as texpand
from repro_torch.replication import migrate as tmigrate
from repro_torch.replication import planner as tplanner


def planned(seed, e=16, ep=4, spare=1, max_rep=2, alive=None):
    rng = np.random.default_rng(seed)
    load = np.exp(rng.normal(0, 1.2, e))
    vis = load * rng.random(e)
    kw = dict(max_replicas=max_rep, vis=vis, vis_weight=0.5,
              rank_alive=alive)
    return (jplanner.plan_replication(load, ep, e // ep + spare, **kw),
            tplanner.plan_replication(load, ep, e // ep + spare, **kw), load)


def _set_equal(a, b):
    assert np.array_equal(a.rep_pos, b.rep_pos)
    assert np.array_equal(a.n_rep, b.n_rep)
    assert (a.n_ranks, a.slots_per_rank) == (b.n_ranks, b.slots_per_rank)


# --------------------------------------------------------------------------
# replica sets
# --------------------------------------------------------------------------
def test_identity_sets_match_reference():
    for kw in (dict(), dict(slots_per_rank=5, max_replicas=2)):
        _set_equal(JSet.identity(16, 4, **kw), TSet.identity(16, 4, **kw))
    t = TTable.identity(16, 4)
    _set_equal(JSet.from_placement(JTable.identity(16, 4), slots_per_rank=5),
               TSet.from_placement(t, slots_per_rank=5))
    assert TSet.identity(16, 4).is_bijective


def test_set_rejects_same_rank_replicas():
    rp = np.array([[0, 1], [2, 2], [4, 4], [6, 6]], np.int32)
    for cls in (JSet, TSet):
        with pytest.raises(ValueError):
            cls(rp, np.array([2, 1, 1, 1], np.int32), 2, 4)


@pytest.mark.parametrize("seed", range(4))
def test_set_views_match_reference(seed):
    alive = None if seed < 3 else np.array([True, False, True, True])
    sj, st, load = planned(seed, alive=alive, spare=1 if alive is None else 2)
    _set_equal(sj, st)
    for name in ("slot_owner", "rep_rank", "ownership_matrix"):
        a, b = getattr(sj, name), getattr(st, name)
        a, b = (a(), b()) if callable(a) else (a, b)
        assert np.array_equal(a, b), name
    assert np.array_equal(sj.rank_loads(load), st.rank_loads(load))
    assert np.array_equal(sj.slot_loads(load), st.slot_loads(load))
    for margin in (1.0, 1.25):
        assert sj.capacity_factor(load, margin, rank_alive=alive) == \
            st.capacity_factor(load, margin, rank_alive=alive)
    wj = sj.residual_split_weights(load, rank_alive=alive)
    wt = st.residual_split_weights(load, rank_alive=alive)
    assert np.array_equal(wj, wt)
    assert np.array_equal(sj.split_schedule(wj), st.split_schedule(wt))
    assert np.array_equal(sj.split_schedule(), st.split_schedule())
    for a, b in zip(sj.as_arrays(), st.as_arrays()):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    mask = np.array([True, True, False, True])
    (mj, lj), (mt, lt) = sj.masked(mask), st.masked(mask)
    _set_equal(mj, mt)
    assert np.array_equal(lj, lt)
    assert [sj.hosts_rank(r) for r in range(4)] == \
        [st.hosts_rank(r) for r in range(4)]


@pytest.mark.parametrize("seed", range(6))
def test_planner_matches_reference(seed):
    sj, st, load = planned(seed, max_rep=2 + seed % 2, spare=1 + seed % 3)
    _set_equal(sj, st)
    rc = dict(spare_per_rank=2, max_replicas=3)
    _set_equal(jplanner.plan_from_config(load, 4, tm.JRCfg(**rc)),
               tplanner.plan_from_config(load, 4, tm.TRCfg(**rc)))


# --------------------------------------------------------------------------
# diffs and weights
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_diff_matches_reference(seed):
    (oj, ot, _), (nj, nt, _) = planned(seed), planned(seed + 10)
    tm.plan_equal(jmigrate.diff(oj, nj, 11), tmigrate.diff(ot, nt, 11))
    tm.plan_equal(jmigrate.diff(nj, oj, 11), tmigrate.diff(nt, ot, 11))
    lj = jmigrate.diff_layers([oj, nj, oj], [nj, nj, oj], 3)
    lt = tmigrate.diff_layers([ot, nt, ot], [nt, nt, ot], 3)
    tm.plan_equal(lj, lt)
    assert lt.n_crossrank == lj.n_crossrank
    assert tmigrate.diff(ot, ot).is_noop


def _stacked(n_blocks=3, e=16, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n_blocks, e, 4, 6)).astype(np.float32)
    return {"blocks": {"layer0": {"moe": {
        "router": rng.normal(size=(4, e)).astype(np.float32),
        "w_gate": w, "w_up": -np.abs(w),         # -0.0 where zeroed
        "w_down": np.ascontiguousarray(np.swapaxes(w, 2, 3))}}}}


def _same(ref, port):
    for k in ("router", "w_gate", "w_up", "w_down"):
        a = np.asarray(ref["blocks"]["layer0"]["moe"][k])
        b = port["blocks"]["layer0"]["moe"][k].numpy()
        assert a.shape == b.shape and np.array_equal(
            a.view(np.uint32), b.view(np.uint32)), k


@pytest.mark.parametrize("layout", ["shared", "per_layer"])
def test_expand_moe_params_matches_reference(layout):
    """The slot expansion (empty spares multiplied by the mask: a negative
    weight gives -0.0) and a replica plan's gather give the reference's
    bytes."""
    params = _stacked()
    sets = [planned(s) for s in (1, 2, 3)]
    ident_j = JSet.identity(16, 4, slots_per_rank=5, max_replicas=2)
    ident_t = TSet.identity(16, 4, slots_per_rank=5, max_replicas=2)
    if layout == "shared":
        lay_j, lay_t = ident_j, ident_t
        pj = jmigrate.diff(ident_j, sets[0][0], 5)
        pt = tmigrate.diff(ident_t, sets[0][1], 5)
    else:
        lay_j, lay_t = [ident_j] * 3, [ident_t] * 3
        pj = jmigrate.diff_layers(lay_j, [s[0] for s in sets], 5)
        pt = tmigrate.diff_layers(lay_t, [s[1] for s in sets], 5)
    want = jexpand(params, lay_j)
    got = texpand(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                               params), lay_t)
    _same(want, got)
    assert (got["blocks"]["layer0"]["moe"]["w_up"][:, 4].view(torch.int32)
            == np.int32(-2 ** 31)).all()          # -0.0 in the empty spare
    tpmigrate.apply_to_params(got, pt)
    _same(jpmigrate.apply_to_params(want, pj), got)
    # a per-layer expansion by distinct sets
    if layout == "per_layer":
        _same(jexpand(params, [s[0] for s in sets]),
              texpand(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                   params), [s[1] for s in sets]))


# --------------------------------------------------------------------------
# weighted split in the MoE layer
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def moe_setup():
    cfg_j, cfg_t, _, _ = tm.model()
    rng = np.random.default_rng(5)
    d, e, f = cfg_t.d_model, cfg_t.moe.num_experts, cfg_t.moe.d_ff
    router = rng.normal(size=(d, e)).astype(np.float32) * 0.2
    router[:, 0] += 0.5                                  # expert 0 hot
    p = {"router": router,
         "w_gate": rng.normal(size=(e, d, f)).astype(np.float32) / d ** .5,
         "w_up": rng.normal(size=(e, d, f)).astype(np.float32) / d ** .5,
         "w_down": rng.normal(size=(e, f, d)).astype(np.float32) / f ** .5}
    x = (rng.normal(size=(2, 16, d)) * 0.5).astype(np.float32)
    mod = rng.random((2, 16)) < 0.6
    return cfg_j, cfg_t, p, x, mod


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["dispatch", "broadcast"])
def test_weighted_replication_matches_reference(moe_setup, mode, weighted):
    """Routing, slot stats and split_frac exact; outputs within the
    kernel-test tolerance (rtol 1e-5, atol 1e-4)."""
    cfg_j, cfg_t, p, x, mod = moe_setup
    e = cfg_t.moe.num_experts
    load = np.ones(e)
    load[0] = 6.0
    rs_j = jplanner.plan_replication(load, 4, e // 4 + 1, max_replicas=2)
    rs_t = tplanner.plan_replication(load, 4, e // 4 + 1, max_replicas=2)
    arrs = list(rs_t.as_arrays())
    if weighted:
        arrs.append(rs_t.split_schedule(rs_t.residual_split_weights(load)))
    owner = rs_t.slot_owner
    keep = (owner >= 0).astype(np.float32)[:, None, None]
    p_rep = {k: (v[np.where(owner >= 0, owner, 0)] * keep
                 if k != "router" else v) for k, v in p.items()}
    kw = dict(gate_gamma=8, md_init=0.0)
    m = np.zeros((1, 4), np.float32)
    valid = np.ones((2, 16), bool)
    valid[1, 11:] = False
    yj, mj, aj = jmoe.ep_moe_forward(
        {k: jnp.asarray(v) for k, v in p_rep.items()}, jnp.asarray(x),
        cfg_j, JCfg(**kw), jnp.asarray(m), jnp.asarray(mod), mode=mode,
        valid=jnp.asarray(valid),
        placement=tuple(jnp.asarray(a) for a in arrs))
    yt, mt, at = tmoe.ep_moe_forward(
        {k: torch.from_numpy(v) for k, v in p_rep.items()},
        torch.from_numpy(x), cfg_t, TCfg(**kw), torch.from_numpy(m),
        torch.from_numpy(mod), mode=mode, valid=torch.from_numpy(valid),
        placement=tuple(torch.from_numpy(a) for a in arrs))
    assert [a.shape for a in arrs] == [tuple(b.shape) for b in
                                       (jnp.asarray(a) for a in arrs)]
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-4)
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    for k in ("slot_load", "slot_vis", "load_d", "vis_d", "expert_load",
              "split_frac", "fp4_ranks", "drop_frac"):
        assert np.array_equal(at[k].numpy(), np.asarray(aj[k])), k
    assert float(at["split_frac"]) > 0.0


def test_weighted_replication_type_and_unknown_width():
    arrs = tuple(torch.zeros(s, dtype=torch.int32)
                 for s in ((4, 2), (4,), (5,), (4, 3)))
    rep = tmoe._as_replication(arrs, 4, 1, "cpu")
    assert isinstance(rep, tmoe.WeightedReplication)
    with pytest.raises(ValueError):
        tmoe._as_replication(arrs[:1] * 5, 4, 1, "cpu")


# --------------------------------------------------------------------------
# manager
# --------------------------------------------------------------------------
REPLICA_CASES = {
    "shared": dict(replan_every=3, warmup_iters=2, min_gain=0.0),
    "weighted": dict(replan_every=2, warmup_iters=1, min_gain=0.0,
                     weighted_split=True, max_replicas=3, spare_per_rank=2),
    "per_layer_churn": dict(replan_every=2, warmup_iters=1, min_gain=0.0,
                            per_layer=True, max_changed_layers=1,
                            weighted_split=True),
    "decode_cadence": dict(replan_every=0, warmup_iters=1, min_gain=0.0,
                           decode_halflife=2.0, decode_replan_every=2),
}


@pytest.mark.parametrize("case", list(REPLICA_CASES))
def test_replica_manager_stream_matches_reference(case):
    from test_torch_placement import drive_managers
    cfg_j, cfg_t, _, _ = tm.model()
    mj, mt = tm.managers(cfg_j, cfg_t, "replication", **REPLICA_CASES[case])
    assert drive_managers(mj, mt, n_iters=16, seed=7) > 0
    for margin in (1.0, 1.25):
        assert mj.capacity_factor(margin) == mt.capacity_factor(margin)
    for it in range(8):
        assert mj.wants_table_refresh(it) == mt.wants_table_refresh(it)
    assert np.array_equal(mj.cum_slot_load, mt.cum_slot_load)
    assert [mj.hosts_rank(r) for r in range(4)] == \
        [mt.hosts_rank(r) for r in range(4)]
    fj, ft = tm.managers(cfg_j, cfg_t, "replication", **REPLICA_CASES[case])
    fj.load_state_dict(mj.state_dict())
    ft.load_state_dict(mj.state_dict())
    tm.state_equal(fj, ft)
    tm.tables_equal(fj, ft)


def test_replica_manager_capacity_before_observation_is_inf():
    cfg_j, cfg_t, _, _ = tm.model()
    mj, mt = tm.managers(cfg_j, cfg_t, "replication")
    assert mt.capacity_factor() == mj.capacity_factor() == float("inf")


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------
def test_engine_live_replication_matches_reference():
    """The replicate arm (weighted split, capacity margin 1.25): same
    tokens, IterStats (split_frac included), tables after every iteration
    and capacity factor."""
    run = tm.run_arm("replicate", n_req=4)     # each resize re-jits JAX
    tm.assert_streams_equal(run)
    assert run.eng_t._placement.n_migrations > 0
    assert any(s.split_frac > 0 for s in run.eng_t.stats)
    assert run.eng_t.cfg.moe.capacity_factor < 2.0


def test_engine_refuses_unexpanded_params():
    cfg_j, cfg_t, _, pnum = tm.model()
    mt = tm.managers(cfg_j, cfg_t, "replication")[1]
    with pytest.raises(ValueError, match="expand_moe_params"):
        tm.TEngine(cfg_t, params_from_numpy(pnum, "cpu"), TCfg(),
                   placement=mt, device="cpu")


@pytest.mark.parametrize("per_layer", [False, True])
def test_engine_aborts_staged_plan_on_failed_apply(monkeypatch, per_layer):
    """A gather that fails after the first block: the landed block is taken
    back, the staged plan aborted, the old set stays routable — and the
    engine still serves exactly the reference's tokens (whose apply is
    functional and leaves the weights untouched) once it fails there at
    the same iteration."""
    from repro.placement import migrate as jpm
    from repro_torch.placement import migrate as tpm
    cfg_j, cfg_t, params, pnum = tm.model()
    rc = dict(replan_every=3, warmup_iters=2, min_gain=0.0,
              per_layer=per_layer)
    mj, mt = tm.managers(cfg_j, cfg_t, "replication", **rc)
    lay = (lambda m: m.rsets if per_layer else m.rset)
    eng_j = tm.JEngine(cfg_j, jexpand(params, lay(mj)), JCfg(**tm.POLICY),
                       placement=mj, **tm.ENGINE)
    eng_t = tm.TEngine(cfg_t, texpand(params_from_numpy(pnum, "cpu"),
                                      lay(mt)),
                       TCfg(**tm.POLICY), placement=mt, device="cpu",
                       **tm.ENGINE)
    before = {k: v.clone() for k, v in
              eng_t.params["blocks"]["layer0"]["moe"].items()}
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg_t.vocab_size, 12).astype(np.int32),
             rng.random(12) < 0.5) for _ in range(6)]
    from repro.serving.scheduler import Request as JReq
    from repro_torch.serving.scheduler import Request as TReq
    for uid, (tok, mod) in enumerate(reqs):
        eng_j.submit(JReq(uid=uid, tokens=tok, modality=mod,
                          max_new_tokens=6, arrival_time=0.0))
        eng_t.submit(TReq(uid=uid, tokens=tok, modality=mod,
                          max_new_tokens=6, arrival_time=0.0))
    orig_t, calls = tpm._gather_rows, []

    def boom(slabs, row):
        calls.append(1)
        if len(calls) == 2:                   # the second block's gather
            raise RuntimeError("simulated gather failure")
        return orig_t(slabs, row)

    def boom_j(params, plan):
        raise RuntimeError("simulated gather failure")

    monkeypatch.setattr(tpm, "_gather_rows", boom)
    monkeypatch.setattr(jpm, "apply_to_params", boom_j)
    with pytest.raises(RuntimeError, match="gather failure"):
        eng_t.run()
    with pytest.raises(RuntimeError, match="gather failure"):
        eng_j.run()
    assert len(calls) == 3          # block 0 landed, block 1 failed, undo 0
    assert eng_t._it == eng_j._it
    assert mt.in_flight is None and mt.n_migrations == 0
    assert all((rs.n_rep == 1).all() for rs in mt.rsets)
    keep = torch.from_numpy(mt.rset.slot_owner >= 0)
    for k in ("w_gate", "w_up", "w_down"):
        v = eng_t.params["blocks"]["layer0"]["moe"][k]
        assert torch.equal(v[:, keep], before[k][:, keep]), k
    monkeypatch.undo()
    done_j = {r.uid: r.generated for r in eng_j.run()}
    done_t = {r.uid: r.generated for r in eng_t.run()}
    assert done_j == done_t and len(done_t) == 6
    assert mt.n_migrations == mj.n_migrations >= 1


def test_engine_failed_undo_still_aborts_and_raises_the_gather_error(
        monkeypatch):
    """The gather fails at the second block and the gather back of the
    first fails too: the staged plan is still aborted (so later replans
    and checkpoint saves are not refused), and the gather's own error is
    the one raised, with the failed undo noted on it."""
    from repro_torch.placement import migrate as tpm
    cfg_j, cfg_t, _, pnum = tm.model()
    mt = tm.managers(cfg_j, cfg_t, "replication", replan_every=3,
                     warmup_iters=2, min_gain=0.0)[1]
    eng = tm.TEngine(cfg_t, texpand(params_from_numpy(pnum, "cpu"),
                                    mt.rset),
                     TCfg(**tm.POLICY), placement=mt, device="cpu",
                     **tm.ENGINE)
    rng = np.random.default_rng(0)
    from repro_torch.serving.scheduler import Request as TReq
    for uid in range(6):
        eng.submit(TReq(uid=uid, tokens=rng.integers(
            0, cfg_t.vocab_size, 12).astype(np.int32),
            modality=rng.random(12) < 0.5, max_new_tokens=6,
            arrival_time=0.0))
    orig, calls = tpm._gather_rows, []

    def boom(slabs, row):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("simulated gather failure")
        if len(calls) > 2:
            raise RuntimeError("simulated undo failure")
        return orig(slabs, row)

    monkeypatch.setattr(tpm, "_gather_rows", boom)
    with pytest.raises(RuntimeError, match="gather failure") as info:
        eng.run()
    assert len(calls) == 3
    assert any("landed block" in n and "undo failure" in n
               for n in getattr(info.value, "__notes__", []))
    assert mt.in_flight is None and mt.n_migrations == 0

"""The port's MoE layer under multi-rank expert parallelism against the
reference's local path.

The reference's own mesh checks (``tests/_dist_worker.py``) hold its
``shard_map`` path against its local path; that half cannot run on this
toolchain (``check_rep`` is gone from jax 0.9's ``shard_map``), so the port
is held against the same local path, on reduced olmoe-1b-7b (8 experts
top-2, every layer MoE).  Each mesh shape runs in spawned gloo ranks
(``_torch_dist.run_ranks``, joined within its deadline); one spawn per
shape runs every case (``_torch_ep_workers.layer_cases``) and each test
checks its case on every rank: outputs within 5e-5, routing stats and the
AIMD state exact, the per-rank FP4 decision (quantizer predicate and FP4
FFN rows zero on the cold ranks), ReaLB and ReaLB-seq bitwise equal, the
collective census equal to ``FlopByteLedger.predict_graph_census``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_ep_workers import layer_cases
from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core import ep_moe as jmoe
from repro_torch.configs import ReaLBConfig, get_config, reduced
from repro_torch.core.policy import realb_policy
from repro_torch.obs.ledger import FlopByteLedger

ARCH = "olmoe-1b-7b"
MESHES = [(1, 2), (1, 4), (2, 2)]
TOL = 5e-5
OFF = dict(gate_gamma=10 ** 9)                          # the gate closed
HOT = dict(gate_gamma=1, md_init=0.0, adaptive=False)   # FP4 where hot
STAT_KEYS = ("load_d", "vis_d", "expert_load", "expert_vis", "slot_load",
             "slot_vis")
N_CALLS = 3                                             # census: 3 layers


def _setup(seed=1, b=4, s=16):
    cfg = jreduced(jget(ARCH))
    e = cfg.moe
    d, n_e, f = cfg.d_model, e.num_experts, e.d_ff
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, n_e)) * 0.2,
         "w_gate": rng.standard_normal((n_e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((n_e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((n_e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    mod = rng.random((b, s)) < 0.6
    return cfg, p, x, mod


def _ref(p, x, cfg, rcfg, m, mod, mode="dispatch", valid=None,
         placement=None):
    """The reference's local path, jitted (its XLA numerics)."""
    fn = jax.jit(partial(jmoe.ep_moe_forward, cfg=cfg, rcfg=JCfg(**rcfg),
                         mode=mode))
    y, m_new, aux = fn({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), m_state=jnp.asarray(m, jnp.float32),
                       modality=jnp.asarray(mod),
                       valid=None if valid is None else jnp.asarray(valid),
                       placement=placement)
    return (np.asarray(y), np.asarray(m_new),
            {k: np.asarray(v) for k, v in aux.items()})


def _skewed(p):
    """Router biased toward experts 0 and 1 (rank 0's): one hot rank."""
    p = dict(p, router=p["router"].copy())
    p["router"][:, 0] += 3.0
    p["router"][:, 1] += 2.5
    return p


def _equal_amax(p, ep):
    """Every rank's slab of each expert stack holds the stack's largest
    |w| (planted in its first expert), so each rank's per-slab global
    scale equals the whole stack's, which the local path quantizes with."""
    p = dict(p)
    n = p["w_gate"].shape[0] // ep
    for k in ("w_gate", "w_up", "w_down"):
        w = p[k].copy()
        amax = np.abs(w).max()
        for r in range(ep):
            w[r * n, 0, 0] = amax
        p[k] = w
    return p


def _replica_tables(n_e, ep, sched_w=None):
    """Expert 0 (hot) replicated onto the last rank's spare slot: ``e_loc +
    1`` slots a rank (the reference's ``check_replication_split_under_ep``
    layout at any EP size).  ``sched_w`` adds a weighted split schedule."""
    from repro.replication import ReplicaSet
    e_loc = n_e // ep
    spr = e_loc + 1
    rep_pos = np.zeros((n_e, 2), np.int32)
    for ex in range(n_e):
        rep_pos[ex] = (ex // e_loc) * spr + ex % e_loc
    rep_pos[0, 1] = (ep - 1) * spr + e_loc
    n_rep = np.ones(n_e, np.int32)
    n_rep[0] = 2
    rs = ReplicaSet(rep_pos, n_rep, ep, spr)
    tables = tuple(np.asarray(a) for a in rs.as_arrays())
    if sched_w is not None:
        tables += (np.asarray(rs.split_schedule(
            None if isinstance(sched_w, str) else sched_w)),)
    return rs, tables


def _cases(shape):
    """Every case of one mesh shape: its rank-side inputs and, computed
    here, the reference's results."""
    rows, ep = shape
    cfg, p, x, mod = _setup()
    n_e = cfg.moe.num_experts
    m_rows = rows if x.shape[0] % rows == 0 else 1
    m9 = np.full((m_rows, ep), 0.9, np.float32)
    m0 = np.zeros((m_rows, ep), np.float32)
    cases, refs = {}, {}

    def add(name, ref, **case):
        case.setdefault("p", p)
        case.setdefault("mod", mod)
        cases[name], refs[name] = case, ref

    add("dispatch", _ref(p, x, cfg, OFF, np.full((1, 1), 0.9), mod),
        x=x, m=m9, rcfg=OFF, mode="dispatch", stop_stage=True)
    xd, md = x[:, :1], mod[:, :1]
    add("broadcast", _ref(p, xd, cfg, OFF, np.full((1, 1), 0.9), md,
                          "broadcast"),
        x=xd, mod=md, m=m9, rcfg=OFF, mode="broadcast")

    # one hot, all-vision rank: FP4 on it alone, against the gate closed
    ps, vis = _skewed(p), np.ones_like(mod)
    add("fp4_hot", None, p=ps, x=x, mod=vis, m=m0, rcfg=HOT,
        mode="dispatch")
    add("fp4_off", None, p=ps, x=x, mod=vis, m=m0,
        rcfg=dict(enabled=False), mode="dispatch")
    add("fp4_hot_seq", None, p=ps, x=x, mod=vis, m=m0,
        rcfg=dict(HOT, overlap=False), mode="dispatch")
    # every rank hot (C = 0, gate always open): each rank quantizes its own
    # slab, the local path the whole stack, with equal global scales
    allhot = dict(gate_gamma=0, capacity_c=0.0, md_init=0.0, adaptive=False)
    pa = _equal_amax(p, ep)
    add("fp4_all", _ref(pa, x, cfg, allhot, np.zeros((1, 1)), vis),
        p=pa, x=x, mod=vis, m=m0, rcfg=allhot, mode="dispatch")

    # chunk padding: zero embeddings past 8 tokens a row, valid-masked
    x_pad = x.copy()
    x_pad[:, 8:] = 0.0
    valid = np.zeros(mod.shape, bool)
    valid[:, :8] = True
    add("padding", _ref(p, x_pad[:, :8], cfg, OFF, np.full((1, 1), 0.9),
                        mod[:, :8]),
        x=x_pad, valid=valid, m=m9, rcfg=OFF, mode="dispatch")

    # a permuted placement (weights laid out by rank_shard)
    rng = np.random.default_rng(5)
    owner = rng.permutation(n_e)                 # physical row -> logical
    pos = np.empty(n_e, np.int64)
    pos[owner] = np.arange(n_e)
    e_loc = n_e // ep
    place = (pos // e_loc).astype(np.int32), (pos % e_loc).astype(np.int32)
    for mode, xx, mm in (("dispatch", x, mod), ("broadcast", xd, md)):
        add(f"placement_{mode}", _ref(p, xx, cfg, OFF, np.full((1, 1), 0.9),
                                      mm, mode),
            x=xx, mod=mm, m=m9, rcfg=OFF, mode=mode, placement=place,
            pos=pos)

    # replication: expert 0 hot, a second replica on the last rank
    ph = dict(p, router=p["router"].copy())
    ph["router"][:, 0] += 4.0
    ref_h = _ref(ph, x, cfg, OFF, np.full((1, 1), 0.9), mod)
    rs, tables = _replica_tables(n_e, ep)
    add("replication", ref_h, p=ph, x=x, m=m9, rcfg=OFF, mode="dispatch",
        placement=tables, rep_pos=rs.rep_pos)
    add("replication_identity", None, p=ph, x=x, m=m9, rcfg=OFF,
        mode="dispatch")
    _, t_eq = _replica_tables(n_e, ep, "equal")
    add("weighted_equal", None, p=ph, x=x, m=m9, rcfg=OFF,
        mode="dispatch", placement=t_eq)
    w = np.zeros((n_e, 2))
    w[:, 0] = 1.0
    w[0] = [2.0, 1.0]
    _, t_w = _replica_tables(n_e, ep, w)
    add("weighted_skew", ref_h, p=ph, x=x, m=m9, rcfg=OFF, mode="dispatch",
        placement=t_w, rep_pos=rs.rep_pos)

    # policy parity with the virtual topology: batch 3 (one group)
    rng = np.random.default_rng(7)
    x3 = (rng.standard_normal((3, 16, cfg.d_model)) * 0.5).astype(np.float32)
    mod3 = rng.random((3, 16)) < 0.6
    pol = dict(gate_gamma=8)
    add("virtual_ep", _ref(p, x3, cfg, pol, np.zeros((1, ep)), mod3),
        x=x3, mod=mod3, m=np.zeros((1, ep), np.float32), rcfg=pol,
        mode="dispatch")

    # the census of N_CALLS chained layers
    add("census", None, x=x, m=m9, rcfg=OFF, mode="dispatch",
        calls=N_CALLS)
    return cases, refs


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"{r}x{m}" for r, m in MESHES])
def ep_run(request, tmp_path_factory):
    """One spawn of the mesh's ranks running every case; the rank results
    by case, the cases and the reference's results."""
    cases, refs = _cases(request.param)
    ranks = run_ranks(layer_cases, request.param, cases,
                      tmp_path_factory.mktemp("ep"))
    return request.param, cases, refs, ranks


def _results(ep_run, name):
    shape, cases, refs, ranks = ep_run
    out = [r[name] for r in ranks]
    for i, o in enumerate(out):
        assert "error" not in o, f"rank {i} {name}:\n{o.get('error')}"
    return shape, cases[name], refs[name], out


def _check_against_local(out, ref, what):
    y_ref = ref[0]
    for i, o in enumerate(out):
        err = float(np.abs(o["y"] - y_ref).max())
        assert err < TOL, (what, i, err)


def test_ep_dispatch_matches_local(ep_run):
    shape, _, ref, out = _results(ep_run, "dispatch")
    _check_against_local(out, ref, "dispatch")
    for o in out:
        assert float(o["aux"]["drop_frac"]) == 0.0
        for k in ("expert_load", "expert_vis", "slot_load", "slot_vis"):
            assert np.array_equal(o["aux"][k], ref[2][k]), k
        assert np.array_equal(o["aux"]["load_d"].sum(0), ref[2]["expert_load"]
                              .reshape(shape[1], -1).sum(-1))
        assert o["m"].shape == (shape[0] if 4 % shape[0] == 0 else 1,
                                shape[1])
        assert np.allclose(o["m"], 0.9)
        # instrumented prefixes are one-rank only
        assert "one-rank only" in o["stop_stage"]


def test_ep_broadcast_matches_local(ep_run):
    _, _, ref, out = _results(ep_run, "broadcast")
    _check_against_local(out, ref, "broadcast")
    for o in out:
        assert np.array_equal(o["aux"]["expert_load"], ref[2]["expert_load"])


def test_realb_fp4_rank_activates(ep_run):
    """One hot rank compresses its experts; the cold ranks do no FP4 work
    (quantizer predicate 0, no FP4 FFN rows); the output moves by a
    quantization-sized amount."""
    shape, case, _, hot = _results(ep_run, "fp4_hot")
    _, _, _, off = _results(ep_run, "fp4_off")
    rows, ep = shape
    for i, (o, f) in enumerate(zip(hot, off)):
        assert float(o["aux"]["fp4_ranks"]) >= 1.0
        diff = float(np.abs(o["y"] - f["y"]).max())
        rel = diff / float(np.abs(f["y"]).max())
        assert 1e-6 < rel < 0.5, rel
        # the decision of this rank's EP group, from its global stats
        g = (i // ep) if o["m"].shape[0] > 1 else 0
        dec = realb_policy(torch.from_numpy(o["aux"]["load_d"][g]),
                           torch.from_numpy(o["aux"]["vis_d"][g]),
                           torch.from_numpy(np.asarray(case["m"])[g]),
                           ReaLBConfig(**case["rcfg"]))
        mine = bool(dec.use_fp4[i % ep])
        assert o["pred"] and set(o["pred"]) == {int(mine)}, (i, o["pred"])
        assert (sum(o["fp4_rows"]) > 0) == mine, (i, o["fp4_rows"])
        assert all(p == 0 for p in f["pred"])
    hot_ranks = [i % ep for i, o in enumerate(hot) if o["pred"][0] == 1]
    assert hot_ranks and len(set(hot_ranks)) < ep   # some, not all, hot


def test_realb_fp4_every_rank_hot_matches_local(ep_run):
    """With every rank hot each rank quantizes its own slab; with equal
    slab maxima that is the local path's whole-stack quantization."""
    _, _, ref, out = _results(ep_run, "fp4_all")
    _check_against_local(out, ref, "fp4_all")
    for o in out:
        assert set(o["pred"]) == {1} and sum(o["fp4_rows"]) > 0
        assert float(o["aux"]["fp4_ranks"]) == ep_run[0][1]


def test_realb_and_seq_bitwise_under_ep(ep_run):
    """ReaLB (dispatch issued before the quantizer) and ReaLB-seq (the
    quantizer after the dispatch) give the same bits."""
    _, _, _, a = _results(ep_run, "fp4_hot")
    _, _, _, b = _results(ep_run, "fp4_hot_seq")
    for oa, ob in zip(a, b):
        assert np.array_equal(oa["y"], ob["y"])
        assert np.array_equal(oa["m"], ob["m"])
        assert oa["pred"] == ob["pred"]


def test_chunk_padding_isolated_under_ep(ep_run):
    _, _, ref, out = _results(ep_run, "padding")
    for o in out:
        err = float(np.abs(o["y"][:, :8] - ref[0]).max())
        assert err < TOL, err
        assert float(o["aux"]["drop_frac"]) == 0.0
        total = float(np.asarray(o["aux"]["load_d"]).sum())
        assert total == 4 * 8 * 2                    # valid tokens only


def test_placement_permuted_matches_local_under_ep(ep_run):
    shape, case, ref, out = _results(ep_run, "placement_dispatch")
    _, case_b, ref_b, out_b = _results(ep_run, "placement_broadcast")
    ep = shape[1]
    for c, r, o_all in ((case, ref, out), (case_b, ref_b, out_b)):
        _check_against_local(o_all, r, c["mode"])
        want = np.zeros(ep)
        np.add.at(want, c["pos"] // (len(c["pos"]) // ep),
                  r[2]["expert_load"])
        for o in o_all:
            got = np.asarray(o["aux"]["load_d"]).reshape(-1, ep).sum(0)
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_replication_split_under_ep(ep_run):
    shape, case, ref, out = _results(ep_run, "replication")
    _, _, _, ident = _results(ep_run, "replication_identity")
    ep = shape[1]
    _check_against_local(out, ref, "replication")
    for o, oi in zip(out, ident):
        aux = o["aux"]
        assert float(aux["split_frac"]) > 0.0
        el = aux["expert_load"]
        assert np.array_equal(el, ref[2]["expert_load"])
        a, b = (aux["slot_load"][case["rep_pos"][0, 0]],
                aux["slot_load"][case["rep_pos"][0, 1]])
        assert a + b == el[0] and a > 0 and b > 0, (a, b, el[0])
        load_d = np.asarray(aux["load_d"]).reshape(-1, ep).sum(0)
        want = _replica_tables(len(el), ep)[0].rank_loads(el)
        # each group's shard-local round-robin counters keep an odd
        # remainder on the primary: one assignment of slack a shard
        assert np.abs(load_d - want).max() <= shape[0] * ep, (load_d, want)
        load_i = np.asarray(oi["aux"]["load_d"]).reshape(-1, ep).sum(0)
        assert load_d[0] < load_i[0]                  # the hot rank shed


def test_weighted_split_under_ep(ep_run):
    shape, case, ref, out = _results(ep_run, "weighted_skew")
    _, _, _, three = _results(ep_run, "replication")
    _, _, _, eq = _results(ep_run, "weighted_equal")
    for o3, oe in zip(three, eq):       # the equal schedule is occ % n_rep
        assert np.array_equal(o3["y"], oe["y"])
        assert np.array_equal(o3["aux"]["slot_load"], oe["aux"]["slot_load"])
    _check_against_local(out, ref, "weighted_skew")
    for o in out:
        el, sl = o["aux"]["expert_load"], o["aux"]["slot_load"]
        a, b = sl[case["rep_pos"][0, 0]], sl[case["rep_pos"][0, 1]]
        assert a + b == el[0]
        assert abs(a - 2.0 * el[0] / 3.0) <= shape[0] * shape[1], (a, el[0])
        assert a > b > 0


def test_virtual_ep_policy_parity(ep_run):
    """The policy over the real EP group equals the reference's over the
    virtual topology of the same size: counts exact, decisions and the
    AIMD state equal."""
    _, _, ref, out = _results(ep_run, "virtual_ep")
    for o in out:
        assert o["m"].shape == (1, ep_run[0][1])     # batch 3: one group
        for k in STAT_KEYS:
            a = np.asarray(ref[2][k]).reshape(-1)
            b = np.asarray(o["aux"][k]).reshape(-1)
            assert np.array_equal(a, b), (k, a, b)
        for k in ("ib_global", "gate_open", "fp4_ranks", "drop_frac",
                  "split_frac"):
            assert abs(float(ref[2][k]) - float(o["aux"][k])) < 1e-6, k
        assert np.array_equal(ref[1], o["m"])


def test_collective_census_matches_prediction(ep_run):
    """One rank's collectives over N_CALLS dispatch layers equal the
    ledger's prediction: 3 all-to-alls and 9 psums (packed into 2
    all-reduces) a layer, and the layout's gathers classed apart."""
    shape, case, _, out = _results(ep_run, "census")
    rows, ep = shape
    cfg = reduced(get_config(ARCH))
    b, s = case["x"].shape[:2]
    m_rows = case["m"].shape[0]
    t_local = (b // m_rows) * (s // ep)
    pred = FlopByteLedger(cfg, ep=ep).predict_graph_census(
        t_local=t_local, layers=N_CALLS, itemsize=4, rows=m_rows)
    for o in out:
        assert o["census"] == pred, (o["census"], pred)

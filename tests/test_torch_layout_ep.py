"""Placement, replication, live migration and elastic serving under the
reference's layout: the default rules (``run_ranks(..., rules={})``), where
the dense part is tensor-parallel over ``model``, the cache is cut over
``kv_seq`` and every weight's D dim, the expert stacks' among them, is cut
over ``data`` (``models.layout``).  The EP-only counterparts are
``test_torch_ep.py``, ``test_torch_ep_migrate.py`` and
``test_torch_ep_elastic.py``; the cases here are theirs, run by the same
rank halves (``_torch_ep_workers.layout_ep_cases``), and held to the same
references:

* on ``(2, 2)`` (data 2: each rank holds ``D/2`` of its slots): the MoE
  layer with permuted placement tables (``_dist_worker.py:126, :147``),
  replicated and weighted splits (``:234, :256, :624``), virtual-EP policy
  parity and its collective census against the ledger's layout terms;
  slab gathers and the bytes they exchange at the cut slab size, the
  expansion onto a rank's share, per-layer tables (``:313, :349``), the
  async drain against the sync apply (``:400``), the global checkpoint
  (byte-equal to a one-device save, read by the reference), ``reshard``
  and ``shrink_mesh`` of an expanded tree with its replica tables
  (``:589``); the EP engine's five managed arms (placement sync shared,
  placement per-layer async, replicate async shared, replicate per-layer
  sync, and a rank killed and rejoined under a ``FaultInjector``) against
  the reference's engine with ``virtual_ep = 2``.  The engine serves
  ``max_slots = 3`` rows: three do not divide over the two data rows, so
  both rows serve the whole batch as one EP group, as the reference's
  engine does, with the expert stacks' D still cut over ``data``;
* on a ``(1, 2)`` sub-mesh of the same ranks: reduced
  jamba-1.5-large-398b's EP engine stream (one-shot prefill, Mamba,
  attention and MoE layers) under the default rules and under
  ``EP_ONLY_RULES``, each against the port's one-device engine;
* on a ``(1, 4)`` mesh of the same ranks (four EP ranks, the reference's
  scenarios; the dense part tensor-parallel over all four): replica
  capacity (``:460``), the async drain, and the kill-rejoin of ``:686``
  with the lost experts re-materialized from the global checkpoint.  A
  ``(2, 4)`` mesh would cut D there too, but its eight ranks cost the
  suite more than the ``(2, 2)`` cases that already cut it: the kill arm
  there patches lost rows into slots whose D the mesh cuts (a
  ``patch_params`` the parent refused as "geometry changed").

Bitwise: slab contents, tables, routing counts, slot statistics,
``m_state``, tokens and the recovered layer against a healthy one.
Logits against the local path within the larger of 5e-5 of max
|local| and 4x the local forward's own move under a two-ulp change of its
embedding (``test_torch_tp.py``'s rule).
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_managers as tm
import test_torch_ep as t_ep
import test_torch_ep_elastic as t_el
import test_torch_ep_migrate as t_mig
from _torch_dist import run_ranks
from _torch_ep_workers import layout_ep_cases
from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core import ep_moe as jmoe
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduced
from repro_torch.obs.ledger import (FlopByteLedger, predict_migration_census,
                                    slot_row_bytes)
from repro_torch.models.common import Mesh
from repro_torch.replication import ReplicaSet
from repro_torch.workloads import arrivals as t_arrivals
from repro_torch.workloads import multimodal as t_multimodal

MESH, WIDE = (2, 2), (1, 4)
TOL, SPREAD = 5e-5, 4.0              # test_torch_tp.py's rule
OFF = dict(gate_gamma=10 ** 9)
ENGINE = dict(max_slots=3, max_len=64, prefill_budget=16)
N_REQ, MAX_PROMPT = 8, 16
LAYER_CASES = ("dispatch", "broadcast", "placement_dispatch",
               "placement_broadcast", "replication", "replication_identity",
               "weighted_equal", "weighted_skew", "virtual_ep", "census")
# the kill-rejoin arm on two EP ranks: four spares a rank, so the
# surviving rank can host every expert while the other is down
KILL_ARM = ("replication", dict(spare_per_rank=4, max_replicas=2,
                                per_layer=True), dict(migrate_async=True))
KILL_FAULTS = [(3, "fail", 1), (14, "rejoin", 1)]
ARMS = {**t_mig.EP_ARMS, "kill": KILL_ARM}
SAVED = ("placement", "replicate/L")       # checkpointed after serving
JAMBA = "jamba-1.5-large-398b"
JAMBA_ENGINE = dict(max_slots=4, max_len=64, prefill_budget=16)


def _moved(fwd, embed):
    """``fwd`` (a function of the embedding table) at the table as it is
    and moved by two f32 ulps either way: the value, and the larger of
    the two moves (a random stack's conditioning)."""
    want = fwd(embed)
    move = max(float(np.abs(fwd(embed * f) - want).max())
               for f in (1 + 2.0 ** -22, 1 - 2.0 ** -22))
    return want, move


def _within(got, want, move, what):
    bound = max(TOL * float(np.abs(want).max()), SPREAD * move)
    err = float(np.abs(got - want).max())
    assert err <= bound, (what, err, bound)


def _arm_payloads(tmp):
    _, _, _, pnum = tm.model()
    out = {}
    for name, (kind, mcfg, ekw) in ARMS.items():
        out[name] = {"arch": tm.ARCH,
                     "arm": (kind, dict(t_mig.MCFG, **mcfg), ekw),
                     "params": pnum, "policy": OFF, "engine": ENGINE,
                     "n_req": N_REQ, "max_prompt": MAX_PROMPT}
        if name in SAVED:
            out[name]["save_to"] = str(tmp / f"port_{name.replace('/', '_')}")
    out["kill"].update(faults=KILL_FAULTS, ckpt_dir=str(tmp / "port_kill"),
                       n_req=10)
    return out


def _ref_arms(tmp):
    out = {}
    for name, arm in ARMS.items():
        kill = name == "kill"
        out[name] = tm.ep_ref_arm(
            arm, dict(t_mig.MCFG), OFF, ENGINE, MESH[1], 10 if kill else N_REQ,
            MAX_PROMPT,
            save_to=str(tmp / f"ref_{name.replace('/', '_')}")
            if name in SAVED else None,
            faults=KILL_FAULTS if kill else None,
            ckpt_dir=str(tmp / "ref_kill") if kill else None)
    return out


def _replica_tables():
    """A replica set of 8 experts in 16 slots, expert ``e`` in slot ``2e``
    and expert 0 replicated into slot 15: every EP size of the reshard's
    meshes (1, 2, 4) holds the same experts a rank, so no rank's dispatch
    buffer overflows where the one-device layer drops nothing."""
    rp = np.repeat(2 * np.arange(8, dtype=np.int32)[:, None], 2, 1)
    rp[0, 1] = 15
    nr = np.ones(8, np.int32)
    nr[0] = 2
    return tuple(np.asarray(a) for a in ReplicaSet(rp, nr, 2, 8).as_arrays())


def _layer_cases():
    """``test_torch_ep``'s cases for ``MESH`` with their references
    deferred: each reference a function that computes it, so the spawn
    starts before the reference's jitted forwards run."""
    ref = t_ep._ref
    t_ep._ref = lambda *a, **k: lambda: ref(*a, **k)
    try:
        cases, refs = t_ep._cases(MESH)
    finally:
        t_ep._ref = ref
    return ({k: cases[k] for k in LAYER_CASES},
            {k: refs[k] for k in LAYER_CASES})


def _jamba_requests():
    cfg = reduced(get_config(JAMBA))
    specs = t_multimodal.make_stream(
        t_multimodal.profile("MMMU"),
        t_arrivals.arrival_times(t_arrivals.ArrivalConfig(
            kind="poisson", rate=40.0, n_requests=4, seed=0)),
        cfg.vocab_size, seed=1, max_prompt=MAX_PROMPT)
    return [(sp.tokens, sp.modality, sp.max_new_tokens) for sp in specs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of four ranks (in a thread while the test process
    computes the references): ``{shape: (cases, refs, ranks, tmp)}`` for
    ``MESH`` and for ``WIDE``, the same ranks' ``(1, 4)`` mesh."""
    cfg2 = jreduced(jget("olmoe-1b-7b"), n_layers=2)     # t_mig.olmoe2
    params2 = jtf.init_model(cfg2, jax.random.PRNGKey(0))
    tokens2 = np.random.default_rng(1).integers(
        0, cfg2.vocab_size, (4, 16)).astype(np.int32)
    olmoe2 = (cfg2, params2, jax.tree.map(np.asarray, params2), tokens2)
    cfg_m, _, params_m, pnum_m = tm.model()
    tmp = tmp_path_factory.mktemp("layout_ep_2x2")
    layer_cases, layer_refs = _layer_cases()
    mig = t_mig._cases(MESH, tmp, olmoe2)
    cases = {
        "layer": layer_cases,
        "migrate": {"gather": mig["gather"], "expand": mig["expand"],
                    "ckpt": dict(mig["ckpt"], layout=True),
                    "layers": mig["layers"], "async": mig["async"],
                    "arms": _arm_payloads(tmp)},
        "elastic": {"reshard": {"arch": tm.ARCH, "params": pnum_m,
                                "tokens": np.random.default_rng(2).integers(
                                    0, cfg_m.vocab_size, (4, 16)).astype(
                                        np.int32),
                                "rcfg": OFF, "replicas": _replica_tables()}},
        "pair": {"arch": JAMBA, "engine": JAMBA_ENGINE,
                 "requests": _jamba_requests()}}
    wide_tmp = tmp_path_factory.mktemp("layout_ep_1x4")
    mig_w = t_mig._cases(WIDE, wide_tmp, olmoe2)
    cfg, p, x, mod = t_el._kill_setup()
    cases["wide"] = {
        "migrate": {"capacity": mig_w["capacity"], "async": mig_w["async"]},
        "elastic": {"kill": {"p": p, "x": x, "mod": mod,
                             "dir": str(wide_tmp / "kill")}}}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(run_ranks, layout_ep_cases, MESH, cases, tmp,
                          400.0, {})
        refs = {"layer": {k: r() if r is not None else None
                          for k, r in layer_refs.items()}}
        m1 = jnp.full((1, MESH[1]), 0.9)
        refs["local"] = _moved(lambda e: np.asarray(jtf.prefill_forward(
            dict(params2, embed=e), cfg2, JCfg(**OFF),
            {"tokens": jnp.asarray(tokens2)}, m1, cache_len=20).logits),
            params2["embed"])
        tok_m = jnp.asarray(cases["elastic"]["reshard"]["tokens"])
        refs["reshard"] = _moved(lambda e: np.asarray(jtf.prefill_forward(
            dict(params_m, embed=e), cfg_m, JCfg(**OFF), {"tokens": tok_m},
            jnp.full((1, 2), 0.9), cache_len=20).logits), params_m["embed"])
        refs["arms"] = _ref_arms(tmp)
        y, _, aux = jmoe.ep_moe_forward(
            {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), cfg,
            JCfg(**OFF), jnp.full((1, 1), 0.9), jnp.asarray(mod),
            mode="dispatch")
        wide_refs = {"y": np.asarray(y), "el": np.asarray(aux["expert_load"])}
        ranks = fut.result()
    return {MESH: (cases, refs, ranks, tmp),
            WIDE: (cases["wide"], wide_refs, [r.get("wide", r) for r in ranks],
                   wide_tmp)}


def _each(runs, shape, part, case):
    """Every rank's result of ``case`` of ``part`` on ``shape`` (a rank's
    error fails the test with its traceback)."""
    cases, refs, ranks, _ = runs[shape]
    got = []
    for i, r in enumerate(ranks):
        assert "error" not in r, f"rank {i}:\n{r['error']}"
        g = r[part] if case is None else r[part][case]
        assert not (isinstance(g, dict) and "error" in g), \
            f"rank {i} {part}/{case}:\n{g['error']}"
        got.append(g)
    return (cases[part] if case is None else cases[part][case]), refs, got


def _layer_run(runs):
    """``test_torch_ep``'s ``ep_run``: the layer cases' results by rank."""
    cases, refs, ranks, _ = runs[MESH]
    for i, r in enumerate(ranks):
        assert "error" not in r, f"rank {i}:\n{r['error']}"
    return MESH, cases["layer"], refs["layer"], [r["layer"] for r in ranks]


# -- the MoE layer -----------------------------------------------------------
def test_layer_holds_its_d_slice_and_matches_local(runs):
    """Each rank holds ``D/2`` of its slots and the layer's output, routing
    statistics and AIMD state are the local path's (dispatch and the
    decode's broadcast)."""
    ep_run = _layer_run(runs)
    d = reduced(get_config(t_ep.ARCH)).d_model
    for o in ep_run[3]:
        assert o["dispatch"]["d_held"] == d // MESH[0]
    t_ep.test_ep_dispatch_matches_local(ep_run)
    t_ep.test_ep_broadcast_matches_local(ep_run)


def test_placement_permuted_matches_local_in_layout(runs):
    """``_dist_worker.py:126, :147``: weights laid out by a permuted table
    against the local path, the rank loads by the table."""
    t_ep.test_placement_permuted_matches_local_under_ep(_layer_run(runs))


def test_replication_split_in_layout(runs):
    """``_dist_worker.py:234, :256``: a replica of the hot expert takes a
    share of its tokens on the other rank; the output is the local
    path's."""
    t_ep.test_replication_split_under_ep(_layer_run(runs))


def test_weighted_split_in_layout(runs):
    """``_dist_worker.py:624``: the equal schedule is the round robin, a
    2:1 schedule splits 2:1."""
    t_ep.test_weighted_split_under_ep(_layer_run(runs))


def test_virtual_ep_policy_parity_in_layout(runs):
    t_ep.test_virtual_ep_policy_parity(_layer_run(runs))


def test_layer_census_is_the_ledgers_layout_terms(runs):
    """``N_CALLS`` chained layers: the expert stacks' D gathered over
    ``data`` (three slabs a layer), the EP collectives of the rank's rows
    and sequence slice, and the statistics gathered over the rows
    (``FlopByteLedger.predict_layout_moe_census``)."""
    shape, cases, _, out = _layer_run(runs)
    case = cases["census"]
    cfg = reduced(get_config(t_ep.ARCH))
    b, s = case["x"].shape[:2]
    groups = case["m"].shape[0]
    pred = FlopByteLedger(cfg, ep=shape[1]).predict_layout_moe_census(
        Mesh(shape, "abstract", "meta"), (b // groups) * (s // shape[1]),
        layers=t_ep.N_CALLS, itemsize=4, groups=groups)
    assert pred["fsdp_all_gather"]["count"] == 3 * t_ep.N_CALLS
    for o in out:
        assert o["census"]["census"] == pred, (o["census"]["census"], pred)


# -- migration -----------------------------------------------------------------
def test_gather_on_cut_slabs_equals_one_device_gather(runs):
    """Shared, per-layer and copying gathers on slots whose D is cut: every
    rank's slots equal its part of the one-device gather, the landed
    blocks are the one-device gather's, and the inverse gather takes the
    permutations back (``apply_to_params``, ``undo_blocks``)."""
    cases, refs, ranks, tmp = runs[MESH]
    t_mig.test_gather_across_ranks_equals_one_device_gather(
        {MESH: (cases["migrate"], refs, [r["migrate"] for r in ranks],
                tmp)}, MESH)


def test_exchanged_bytes_are_the_plans_cut_rows(runs):
    """Each rank's ``Comm.exchange_rows`` census is
    ``predict_migration_census`` of the plan: the rows it sends another
    rank of its data row's EP group (``crossrank_sends``) times one slot's
    slabs at the rank's ``D/2`` slice, half the EP-only layout's."""
    c, _, got = _each(runs, MESH, "migrate", "gather")
    ep = MESH[1]
    w = c["plans"]["shared"][0]["blocks"]["layer0"]["moe"]["w_gate"]
    d, f = w.shape[-2:]
    row = slot_row_bytes(d, f, 4, Mesh(MESH, "abstract", "meta"))
    assert row == t_mig.ROW_BYTES // MESH[0]
    for i, r in enumerate(got):
        for name, (_, rows, _) in c["plans"].items():
            blocks = 1 if rows.ndim == 2 else t_mig.L + (name == "shared")
            pred = predict_migration_census(rows, ep, row, blocks)[i % ep]
            assert r[name]["sent"] == pred["migrate_all_to_all"]["bytes"], \
                (name, i)


def test_expand_onto_a_ranks_cut_share(runs):
    _, _, got = _each(runs, MESH, "migrate", "expand")
    for r in got:
        assert r == {"identity": True, "per_layer": True}


def test_perlayer_identity_bitwise_in_layout(runs):
    """``_dist_worker.py:313``: stacked identity tables, the shared
    identity table and none give the same bits, prefill and decode."""
    _, _, got = _each(runs, MESH, "migrate", "layers")
    for r in got:
        assert r["identity_bitwise"]


def test_perlayer_tables_match_local_in_layout(runs):
    """``_dist_worker.py:349``: per-layer permutation tables over weights
    permuted by them, against the reference's table-free local
    forward."""
    _, refs, got = _each(runs, MESH, "migrate", "layers")
    want, move = refs["local"]
    for r in got:
        _within(r["perm_logits"], want, move, "perm_logits")
        assert np.array_equal(r["perm_logits"], got[0]["perm_logits"])


@pytest.mark.parametrize("shape", [MESH, WIDE], ids=["2x2", "1x4"])
def test_async_chunks_match_sync_in_layout(runs, shape):
    """``_dist_worker.py:400`` (with four EP ranks too): a staged
    per-layer plan drained one layer a chunk equals the synchronous apply
    bit for bit, and the whole reduced olmoe gives the same logits through
    either copy."""
    _, _, got = _each(runs, shape, "migrate", "async")
    for r in got:
        assert r["layers"] == 2 and r["n_drains"] == 2
        assert r["same_gather"] and r["bitwise"] and r["tables"]
        assert r["calibrated"] and r["logits_equal"]


def test_replica_capacity_reduced_cap_in_layout(runs):
    """``_dist_worker.py:460`` on four EP ranks: at the post-split
    capacity the replicated layout drops nothing, the bijective one
    overflows."""
    _, _, got = _each(runs, WIDE, "migrate", "capacity")
    for r in got:
        assert r["hot"] > 0.4 and r["bij_overflows"]
        assert r["drop_rep"] == 0.0 and r["drop_bij"] > 0.0


# -- checkpoints -----------------------------------------------------------
def test_global_checkpoint_in_layout_equals_one_device(runs):
    """Saved under the layout (every expert leaf gathered over ``model``
    and ``data``): byte for byte the one-device save, and the reference
    reads it; restored onto this mesh and onto ``(1, 4)`` each rank holds
    its part."""
    cases, refs, ranks, tmp = runs[MESH]
    wrapped = {MESH: (cases["migrate"], refs,
                      [r["migrate"] for r in ranks], tmp)}
    t_mig.test_global_checkpoint_equals_one_device_and_loads_in_reference(
        wrapped, MESH)
    t_mig.test_restore_onto_the_mesh_and_another_ep_size(wrapped, MESH)


# -- the EP engine's managed arms ------------------------------------------
@pytest.mark.parametrize("arm", list(ARMS))
def test_engine_arm_matches_reference_engine(runs, arm):
    """The EP engine under the layout against the reference's engine with
    ``virtual_ep = 2``: the same tokens and finish times on every rank,
    every ``IterStats`` field (a replicated arm's ``ib_global`` and
    ``split_frac`` aside: each rank splits its own tokens, see
    ``test_torch_ep_migrate``), the tables after every iteration, the AIMD
    state, bytes moved and reported; each data row's EP group exchanges
    its ``D/2`` slices, so the ranks' exchanged bytes sum to what the
    plans moved.  The kill arm: the coordinator's events, the refused
    mid-recovery checkpoint, availability and lost tokens, as
    ``test_torch_ep_elastic``'s."""
    _, refs, got = _each(runs, MESH, "migrate", "arms")
    ref = refs["arms"][arm]
    split = ARMS[arm][0] == "replication"
    for r in (g[arm] for g in got):
        assert r["tokens"] == ref["tokens"]
        assert r["finish"] == ref["finish"]
        assert len(r["stats"]) == len(ref["stats"])
        for i, (a, b) in enumerate(zip(ref["stats"], r["stats"])):
            if split:
                a = {k: v for k, v in a.items()
                     if k not in t_mig.SPLIT_STATS}
                b = {k: v for k, v in b.items()
                     if k not in t_mig.SPLIT_STATS}
            assert a == b, (i, a, b)
        assert r["stats"] == got[0][arm]["stats"]
        assert len(r["tables"]) == len(ref["tables"])
        for i, (a, b) in enumerate(zip(ref["tables"], r["tables"])):
            assert all(np.array_equal(np.asarray(x), y)
                       for x, y in zip(a, b)), i
        assert np.array_equal(r["m"], got[0][arm]["m"])
        if not split:
            assert np.array_equal(r["m"], ref["m"])
        assert r["moved"] == ref["moved"] > 0
        assert r["observed"] == ref["observed"]
        assert r["cap"] == ref["cap"]
        if arm == "kill":
            assert r["events"] == ref["events"]
            assert r["refused"][0] == ref["refused"][0]
            assert r["summary"] == ref["summary"]
        else:
            assert r["commits"] == ref["commits"] > 0
    assert sum(g[arm]["sent"] for g in got) == ref["moved"]
    for row in range(MESH[0]):
        mine = got[row * MESH[1]:(row + 1) * MESH[1]]
        assert sum(g[arm]["sent"] for g in mine) * MESH[0] == ref["moved"]
    if arm == "kill":
        assert [e["kind"] for e in ref["events"]][:2] == ["fail",
                                                          "recovered"]
        assert any(s["lost_tokens"] > 0 for s in got[0][arm]["stats"])


@pytest.mark.parametrize("arm", SAVED)
def test_engine_checkpoint_in_layout_equals_reference_engine(runs, arm):
    """After serving, the layout engine's checkpoint (``S`` physical slots
    where the arm replicates) holds the reference's engine's arrays byte
    for byte (a replica manager's ``cum_slot_load`` aside: the per-rank
    split of ``test_engine_arm_matches_reference_engine``), the port's
    engine reads it back to the same bits, and a reference engine restores
    it to its own weights and tables."""
    _, refs, got = _each(runs, MESH, "migrate", "arms")
    ref = refs["arms"][arm]
    tmp = runs[MESH][3]
    tag = arm.replace("/", "_")
    assert {g[arm]["saved"] for g in got} == {
        str(tmp / f"port_{tag}" / "step_00000005")}
    assert all(g[arm]["reloaded"] for g in got)
    kind = ARMS[arm][0]
    for group in ("serving", kind):
        a = np.load(tmp / f"port_{tag}" / "step_00000005" / f"{group}.npz")
        b = np.load(tmp / f"ref_{tag}" / "step_00000005" / f"{group}.npz")
        assert sorted(a.files) == sorted(b.files), group
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            if k != "cum_slot_load":
                assert a[k].tobytes() == b[k].tobytes(), k
    cfg_j, _, params, _ = tm.model()
    mcfg = dict(t_mig.MCFG, **ARMS[arm][1])
    if kind == "placement":
        mgr = tm.JPM(cfg_j, tm.JPCfg(**mcfg), MESH[1])
    else:
        from repro.replication import expand_moe_params as jexpand
        mgr = tm.JRM(cfg_j, tm.JRCfg(**mcfg), MESH[1])
        params = jexpand(params, mgr.rsets if mgr.per_layer else mgr.rset)
    fresh = tm.JEngine(cfg_j, params, JCfg(**OFF), placement=mgr,
                       virtual_ep=MESH[1], **ENGINE)
    fresh.load_checkpoint(str(tmp / f"port_{tag}"))
    for a, b in zip(jax.tree.leaves(fresh.params),
                    jax.tree.leaves(ref["engine"].params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(mgr.device_tables(), ref["manager"].device_tables()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# -- elastic serving -----------------------------------------------------------
def test_kill_zeroes_only_the_dead_ranks_slots_in_layout(runs):
    """EP rank 2 of four killed: its process zeroes its slots, no other
    process any."""
    _, _, got = _each(runs, WIDE, "elastic", "kill")
    for i, r in enumerate(got):
        assert r["zeroed"] == (i == 2), i
        assert r["kept"] == (i != 2), i


def test_kill_strands_singletons_and_keeps_the_replica_in_layout(runs):
    refs, got = _each(runs, WIDE, "elastic", "kill")[1:]
    for r in got:
        assert r["lost"] == [4, 5]
        assert r["state_degraded"] == "degraded"
        assert r["live_off_dead"] and r["replica_masked"] == (1, 0)
        el, sl = r["el_deg"], r["sl_deg"]
        assert np.array_equal(el, refs["el"])
        assert sl[2 * t_el.SPR] == el[4] and sl[2 * t_el.SPR + 1] == el[5]
        assert r["lost_tokens"] == el[4] + el[5]
        assert np.array_equal(r["y_deg"], got[0]["y_deg"])


def test_effective_mesh_drops_the_dead_model_slice(runs):
    """``(1, 4)`` minus EP rank 2: ``(1, 3)`` over ranks 0, 1 and 3, of
    which the dead rank's process is no member."""
    _, _, got = _each(runs, WIDE, "elastic", "kill")
    for i, r in enumerate(got):
        assert r["effective"] == (1, 3, [[0, 1, 3]], i != 2), i


def test_recovery_rematerializes_from_the_global_checkpoint_in_layout(
        runs):
    """The lost experts' rows come from the checkpoint saved in the
    layout: nothing is left to recover, the layer is bit for bit a fresh
    expansion's and within the reference's tolerance of its local path;
    the recovery exchange carries the plan's cross-rank slots, one slot's
    slabs each (``slot_row_bytes``); the rejoined rank is routable once
    the warm-up plan lands.  (The kill arm of
    ``test_engine_arm_matches_reference_engine`` patches rows at a
    ``D/2`` slice.)"""
    refs, got = _each(runs, WIDE, "elastic", "kill")[1:]
    cfg = reduced(get_config("olmoe-1b-7b"))
    row = slot_row_bytes(cfg.d_model, cfg.moe.d_ff, 4,
                         Mesh(WIDE, "abstract", "meta"))
    for i, r in enumerate(got):
        assert r["recovered"] == (False, True, False), i
        assert r["rec_bitwise"], i
        assert float(np.abs(r["y_rec"] - refs["y"]).max()) < t_el.TOL
        for ex, slots in r["rec_slots"].items():
            assert r["sl_rec"][slots].sum() == refs["el"][ex], ex
        assert r["patched_bytes"] % (row // 3) == 0
        assert r["state_warming"] == "warming"
        assert r["state_final"] == "healthy" and r["hosts_after"]
        assert float(np.abs(r["y_fin"] - refs["y"]).max()) < t_el.TOL
    assert sum(r["patched_bytes"] for r in got) > 0
    assert sum(r["recovery_sent"] for r in got) \
        == got[0]["recovery_plan_rows"] * row


@pytest.mark.parametrize("mesh", ["here", "lost_data_row", "lost_ep_rank",
                                  "other_ep"])
def test_reshard_of_an_expanded_tree_serves_the_same_logits(runs, mesh):
    """``_dist_worker.py:589`` with a managed tree: experts expanded into
    16 replica slots placed by ``reshard(spec=)`` on ``(2, 2)``, minus
    data row 1, minus EP rank 0 (``shrink_mesh``) and on ``(1, 4)``; every
    member's prefill logits through the replica tables against the
    reference's table-free local forward; ranks outside a shrunk mesh
    hold nothing."""
    _, refs, got = _each(runs, MESH, "elastic", "reshard")
    want_shape = {"here": ((2, 2), [[0, 1], [2, 3]]),
                  "lost_data_row": ((1, 2), [[0, 1]]),
                  "lost_ep_rank": ((2, 1), [[1], [3]]),
                  "other_ep": ((1, 4), [[0, 1, 2, 3]])}[mesh]
    want, move = refs["reshard"]
    members = 0
    for r in got:
        res = r[mesh]
        assert (tuple(res["shape"]), res["ranks"]) == want_shape
        if not res["member"]:
            assert res["logits"] is None
            continue
        members += 1
        _within(res["logits"], want, move, mesh)
    assert members == want_shape[0][0] * want_shape[0][1]


# -- reduced jamba's engine on a (1, 2) mesh (ROADMAP A14, the CPU half) -----
@pytest.mark.parametrize("rules", ["layout", "ep_only"])
def test_jamba_engine_stream_matches_one_device(runs, rules):
    """Reduced jamba-1.5-large-398b's EP engine (one-shot prefill) on two
    ranks, under the default rules and under ``EP_ONLY_RULES``: the same
    tokens and ``m_state`` as the port's one-device engine over the
    virtual topology of two ranks."""
    _, _, ranks, _ = runs[MESH]
    for i, r in enumerate(ranks[:2]):
        res = r[f"pair_{rules}"]
        assert "error" not in res, f"rank {i}:\n{res['error']}"
        assert res["got"]["tokens"] == res["ref"]["tokens"]
        assert len(res["got"]["tokens"]) == 4
        np.testing.assert_array_equal(res["got"]["m"], res["ref"]["m"])
    assert "pair_layout" not in ranks[2]

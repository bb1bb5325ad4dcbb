"""Cross-rank migration under multi-rank expert parallelism: the port's
slab gathers, expansion, checkpoints and serving arms on ``(1, 2)``,
``(1, 4)`` and ``(2, 2)`` meshes of spawned gloo ranks, against the
one-device gather and the reference's local path and engine.

One spawn a mesh (``_torch_dist.run_ranks``, joined within its deadline)
runs every case (``_torch_ep_workers.migrate_cases``); the test process
computes the reference meanwhile.  Counterparts of the reference's mesh
checks, which cannot run on this toolchain (``tests/_dist_worker.py``,
``check_rep`` is gone from jax 0.9's ``shard_map``):

- ``check_perlayer_identity_bitwise_under_ep`` (``_dist_worker.py:313``):
  ``test_perlayer_identity_bitwise_under_ep``;
- ``check_perlayer_tables_matches_local_under_ep`` (``:349``):
  ``test_perlayer_tables_match_local_under_ep``;
- ``check_async_migrate_chunks_match_sync_under_ep`` (``:400``):
  ``test_async_chunks_match_sync_under_ep``;
- ``check_replica_capacity_reduced_cap`` (``:460``):
  ``test_replica_capacity_reduced_cap_under_ep``.

Beyond those: gathers by global rows on a rank's slots equal the
one-device gather bit for bit and send exactly the plan's cross-rank rows;
a failure on one rank stops and rolls back every rank; ranks whose clocks
differ pack the same chunks; the expansion onto a rank's share of the
slots; the parent's per-rank checkpoint save (every rank writing its own
shard into one directory) against the global save, which the reference
reads, and the restore onto this mesh and another EP size; and the EP
engine with placement and replica managers (sync and async, shared and
per-layer) against the reference's engine with ``virtual_ep = ep`` on
reduced moonshot: the same tokens, ``IterStats``, tables after every
iteration, bytes moved, and the bytes each rank exchanged summing to them.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_managers as tm
from _torch_dist import run_ranks
from _torch_ep_workers import migrate_cases
from repro.checkpoint import ckpt as jckpt
from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import transformer as jtf
from repro_torch.placement.migrate import crossrank_sends
from repro_torch.replication import ReplicaSet

MESHES = [(1, 2), (1, 4), (2, 2)]
ARMS_MESH = (1, 4)
S, L, E = 12, 3, 8                   # the gather trees' slots and blocks
RTOL, ATOL_REL = 1e-4, 3e-5          # test_torch_model.py's
OFF = dict(gate_gamma=10 ** 9)       # the gate closed: FP4 never fires
ENGINE = dict(max_slots=4, max_len=64, prefill_budget=16)
N_REQ, MAX_PROMPT = 8, 16
# sync and async, shared and per-layer, both managers
EP_ARMS = {
    "placement": tm.ARMS["placement"],
    "placement/L/async": tm.ARMS["placement/L/async"],
    "replicate/async": ("replication", dict(spare_per_rank=1,
                                            max_replicas=2),
                        dict(migrate_async=True)),
    "replicate/L": tm.ARMS["replicate/L"],
}
MCFG = dict(replan_every=4, warmup_iters=2, min_gain=0.0)
SPLIT_STATS = ("ib_global", "split_frac")


def _tree(rng, lead, prefix=False):
    shapes = {"w_gate": (4, 6), "w_up": (4, 6), "w_down": (6, 4)}
    moe = {k: rng.standard_normal(lead + v).astype(np.float32)
           for k, v in shapes.items()}
    tree = {"blocks": {"layer0": {"moe": moe}}}
    if prefix:
        tree["prefix"] = {"0": {"moe": {
            k: rng.standard_normal((lead[-1],) + v).astype(np.float32)
            for k, v in shapes.items()}}}
    return tree


ROW_BYTES = 3 * 24 * 4               # one slot's three slabs, f32


def _gather_plans():
    rng = np.random.default_rng(7)
    shared = rng.permutation(S)
    per_layer = np.stack([rng.permutation(S), np.arange(S),
                          rng.permutation(S)])
    dup = np.arange(S)
    dup[[1, 5, 9, 10]] = [11, 0, 2, 2]          # copies, no inverse
    return {
        "shared": (_tree(rng, (L, S), prefix=True), shared,
                   np.argsort(shared)),
        "per_layer": (_tree(rng, (L, S)), per_layer,
                      np.argsort(per_layer, axis=1)),
        "copies": (_tree(rng, (L, S)), dup, np.arange(S))}


def _skew(n_layers, seed):
    """Per-layer stats whose two hot experts share a rank (at EP 2 and 4)
    in every layer, so every layer's plan moves experts."""
    rng = np.random.default_rng(seed)
    es = np.ones((n_layers, 2, E))
    for l in range(n_layers):
        hot = 2 * int(rng.integers(0, E // 2))
        es[l, 0, hot], es[l, 0, hot + 1] = 10.0, 8.0
    es[:, 1] = es[:, 0] * 0.5
    return es


def _sets(ep):
    """(rep_pos, n_rep, spr) of an identity set with a spare a rank, and
    of per-layer sets each replicating one expert onto a spare."""
    spr = E // ep + 1
    ident = ReplicaSet.identity(E, ep, slots_per_rank=spr, max_replicas=2)
    per = []
    for l in range(L):
        rp, nr = ident.rep_pos.copy(), ident.n_rep.copy()
        ex = (3 * l + 1) % E
        rank = (ex // (E // ep) + 1) % ep
        rp[ex, 1], nr[ex] = rank * spr + spr - 1, 2
        per.append((rp, nr, spr))
    return {"identity": {ep: [(ident.rep_pos, ident.n_rep, spr)]},
            "per_layer": {ep: per}}


def _perm_tables(ep, n_blocks):
    rng = np.random.default_rng(5)
    e2r, slot = [], []
    for _ in range(n_blocks):
        owner = rng.permutation(E)
        pos = np.empty(E, np.int64)
        pos[owner] = np.arange(E)
        e2r.append(pos // (E // ep))
        slot.append(pos % (E // ep))
    return np.stack(e2r).astype(np.int32), np.stack(slot).astype(np.int32)


def _moe_setup():
    """The reference's ``_moe_setup`` from numpy draws, with its hot expert
    0 (feature 0 a constant 1.0 that only expert 0's router column
    reads)."""
    cfg = jreduced(jget("olmoe-1b-7b"))
    d, n_e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff
    rng = np.random.default_rng(1)
    p = {"router": rng.standard_normal((d, n_e)) * 0.2,
         "w_gate": rng.standard_normal((n_e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((n_e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((n_e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["router"][0, :] = 0.0
    p["router"][0, 0] = 8.0
    x = (rng.standard_normal((4, 16, d)) * 0.5).astype(np.float32)
    x[..., 0] = 1.0
    return p, x, rng.random((4, 16)) < 0.6


@pytest.fixture(scope="module")
def olmoe2():
    cfg = jreduced(jget("olmoe-1b-7b"), n_layers=2)
    params = jtf.init_model(cfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    return cfg, params, jax.tree.map(np.asarray, params), tokens


def _cases(shape, tmp, olmoe2):
    ep = shape[1]
    cfg, _, np_params, tokens = olmoe2
    rng = np.random.default_rng(3)
    _, n_blocks, _ = jtf.block_structure(cfg)
    plans = _gather_plans()
    p, x, mod = _moe_setup()
    return {
        "gather": {"plans": plans},
        "failure": {"plan": plans["per_layer"], "fail_rank": ep - 1,
                    "experts": E, "layers": L, "stats": _skew(L, 11),
                    "params": _tree(rng, (L, E))},
        "agree": {"experts": E, "layers": 6, "bpe": 10, "bw": 1000.0,
                  "iter_s": 0.02, "stats": _skew(6, 13),
                  "params": _tree(rng, (6, E))},
        "expand": {"logical": _tree(rng, (L, E)), "sets": _sets(ep)},
        "ckpt": {"dir": str(tmp), "tree": _tree(rng, (L, E))},
        "layers": {"params": np_params, "tokens": tokens,
                   "perm_tables": _perm_tables(ep, n_blocks)},
        "async": {"params": np_params, "tokens": tokens,
                  "stats": _async_stats()},
        # the reference's scenario is one of four EP ranks: at two, the
        # capacity buffers' rounding to 8 rows absorbs the bijective peak
        **({"capacity": {"p": p, "x": x, "mod": mod}} if ep == 4 else {}),
    }


def _async_stats():
    """The reference's ``check_async_migrate_chunks_match_sync_under_ep``
    stats: layer 0 hot at experts 0-1, layer 1 at 6-7."""
    es = np.zeros((2, 2, E))
    es[0, 0] = [10.0, 8, 1, 1, 1, 1, 1, 1]
    es[1, 0] = [1.0, 1, 1, 1, 1, 1, 8, 10]
    es[:, 1] = es[:, 0] * 0.5
    return es


def _arm_payloads(tmp):
    _, _, _, pnum = tm.model()
    out = {}
    for name, (kind, mcfg, ekw) in EP_ARMS.items():
        out[name] = {"arch": tm.ARCH, "arm": (kind, dict(MCFG, **mcfg), ekw),
                     "params": pnum, "policy": OFF, "engine": ENGINE,
                     "n_req": N_REQ, "max_prompt": MAX_PROMPT}
    out["placement"]["save_to"] = str(tmp / "ep_engine")
    return out


@pytest.fixture(scope="module")
def runs(olmoe2, tmp_path_factory):
    """Every mesh's ranks (spawned in turn, each in a thread while the
    test process computes that mesh's references)."""
    cfg, params, _, tokens = olmoe2
    out = {}
    for shape in MESHES:
        tmp = tmp_path_factory.mktemp(f"ep_migrate_{shape[0]}x{shape[1]}")
        cases = _cases(shape, tmp, olmoe2)
        if shape == ARMS_MESH:
            cases["arms"] = _arm_payloads(tmp)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(run_ranks, migrate_cases, shape, cases, tmp)
            m1 = jnp.full((1, shape[1]), 0.9)
            refs = {"local_logits": np.asarray(jtf.prefill_forward(
                params, cfg, JCfg(**OFF), {"tokens": jnp.asarray(tokens)},
                m1, cache_len=20).logits)}
            if shape == ARMS_MESH:
                refs["arms"] = {
                    name: tm.ep_ref_arm(EP_ARMS[name], dict(MCFG), OFF,
                                        ENGINE, shape[1], N_REQ, MAX_PROMPT,
                                        save_to=str(tmp / "ref_engine")
                                        if name == "placement" else None)
                    for name in EP_ARMS}
            ranks = fut.result()
        out[shape] = (cases, refs, ranks, tmp)
    return out


def _each(runs, shape, case):
    """Every rank's result of ``case`` on ``shape`` (a rank's error
    fails the test with its traceback)."""
    cases, refs, ranks, tmp = runs[shape]
    got = [r[case] for r in ranks]
    for i, g in enumerate(got):
        assert not (isinstance(g, dict) and "error" in g), \
            f"rank {i}:\n{g['error']}"
    return cases[case], refs, got


meshes = pytest.mark.parametrize("shape", MESHES,
                                 ids=[f"{r}x{m}" for r, m in MESHES])


@meshes
def test_gather_across_ranks_equals_one_device_gather(runs, shape):
    """A shared permutation (stacked blocks and an unstacked layer), a
    per-layer one with an identity layer, and a gather that copies slots:
    every rank's slots equal its slice of the one-device gather, the
    landed blocks are the one-device gather's, and the inverse gather
    takes the permutations back."""
    _, _, got = _each(runs, shape, "gather")
    for r in got:
        for name, res in r.items():
            assert res["equal"], name
            assert res["landed"] == res["ref_landed"], name
            assert res["back"] or name == "copies", name
    assert len(got[0]["per_layer"]["landed"]) == 2     # the identity layer


@meshes
def test_exchanged_bytes_equal_the_plans_crossrank_count(runs, shape):
    """Each rank sends exactly the rows whose source it holds and whose
    destination another rank holds (counted independently here), and the
    port's ``crossrank_sends`` counts the same."""
    c, _, got = _each(runs, shape, "gather")
    ep = shape[1]
    n = S // ep
    for i, r in enumerate(got):
        my = i % ep
        for name, (_, rows, _) in c["plans"].items():
            rows2 = np.atleast_2d(rows)
            want = 0
            for row in rows2:
                dst = np.arange(S)
                moved = (row != dst) & (row // n != dst // n)
                want += int(np.sum(moved & (row // n == my)))
            # a shared row gathers every block (and the prefix layer)
            blocks = 1 if rows.ndim == 2 else L + (name == "shared")
            assert r[name]["sent"] == want * blocks * ROW_BYTES, (name, i)
            sends = crossrank_sends(rows, ep)
            per = int(np.atleast_2d(sends)[:, my].sum()) * blocks
            assert per * ROW_BYTES == r[name]["sent"], (name, i)


@meshes
def test_failure_on_one_rank_rolls_back_every_rank(runs, shape):
    """A read that fails on one rank at the second changed block stops
    every rank at that block: the same block landed everywhere, the failing
    rank raises its error and the others ``PeerMigrationError``, and the
    roll back restores every rank's slots.  A recovery patch that fails on
    one rank aborts the executor's batch on every rank: the plan is
    dropped, the tables stay, the landed blocks go back."""
    c, _, got = _each(runs, shape, "failure")
    ep = shape[1]
    for i, r in enumerate(got):
        failing = i == c["fail_rank"]          # data row 0, last EP rank
        assert r["apply"] == ("own" if failing else "peer"), (i, r["apply"])
        assert r["landed"] == [("blocks", "layer0", 0)], (i, r["landed"])
        assert r["aborted"] == 1 and r["rolled_back"], i
        assert r["drain"] == ("own" if failing else "peer"), i
        assert not r["drain_in_flight"] and r["drain_tables_kept"], i
        assert r["drain_rolled_back"], i
    assert ep >= 2


@meshes
def test_ranks_with_different_clocks_pack_the_same_chunks(runs, shape):
    """Each rank's own iteration seconds would give each its own budget;
    agreed, every rank packs the same chunks in the same order, at the
    largest budget."""
    c, _, got = _each(runs, shape, "agree")
    local = [r["local_budget"] for r in got]
    assert len(set(local)) == len(got)         # the clocks disagree
    for r in got:
        assert r["chunks"] == got[0]["chunks"]
        assert r["budgets"] == [max(local)] * len(r["budgets"])
        assert r["wall"] == pytest.approx(0.01 * len(got))
    assert len(got[0]["chunks"]) >= 2
    assert sorted(sum(got[0]["chunks"], [])) == sorted(
        set(sum(got[0]["chunks"], [])))


@meshes
def test_expand_onto_a_ranks_share_of_the_slots(runs, shape):
    _, _, got = _each(runs, shape, "expand")
    for r in got:
        assert r == {"identity": True, "per_layer": True}


@meshes
def test_parent_per_rank_save_was_broken(runs, shape):
    """What the parent's ``Engine.save_checkpoint`` did under a mesh: every
    rank saved its own shard into one directory.  Either a rank's save
    failed in the race on the temp directory, or what landed holds one
    rank's ``S/ep`` slots, not the global layout, so neither the reference
    nor another rank can read it as the model."""
    c, _, got = _each(runs, shape, "ckpt")
    tmp = runs[shape][3]
    broke = [r["per_rank"] for r in got if r["per_rank"] != "saved"]
    if not broke:
        flat = jckpt.restore_group(str(tmp / "per_rank"), "serving")
        w = flat["params|blocks|layer0|moe|w_gate"]
        assert w.shape[-3] == E // shape[1] != E, w.shape


@meshes
def test_global_checkpoint_equals_one_device_and_loads_in_reference(
        runs, shape):
    """The checkpoint saved under the mesh holds the same arrays, byte for
    byte, as the one-device save of the whole tree (bf16 stacks as their
    raw patterns with their dtype), and the reference restores it."""
    c, _, got = _each(runs, shape, "ckpt")
    tmp = runs[shape][3]
    assert len({r["path"] for r in got}) == 1
    for group in ("serving", "placement"):
        a = np.load(tmp / "global" / "step_00000003" / f"{group}.npz")
        b = np.load(tmp / "one_device" / "step_00000003" / f"{group}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k
    tree = c["tree"]["blocks"]["layer0"]["moe"]
    _, out = jckpt.restore(str(tmp / "global"), {"serving": {
        "params": {"blocks": {"layer0": {"moe": {
            k: np.zeros(v.shape, np.float32) for k, v in tree.items()}}}},
        "m_state": np.zeros((1, shape[1]), np.float32)}})
    moe = out["serving"]["params"]["blocks"]["layer0"]["moe"]
    for k, v in tree.items():
        want = v if k != "w_down" else _bf16(v)
        assert np.array_equal(np.asarray(moe[k], np.float32), want), k


def _bf16(a):
    """f32 rounded to bf16 (round to nearest even), as f32."""
    import torch
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@meshes
def test_restore_onto_the_mesh_and_another_ep_size(runs, shape):
    """Each rank reads its own slots of the saved stacks, on this mesh and
    on a mesh of another EP size over the same ranks."""
    _, _, got = _each(runs, shape, "ckpt")
    for r in got:
        assert r["restored"]
        ep_other, ok = r["restored_other_ep"]
        assert ep_other != shape[1] and ok


@meshes
def test_perlayer_identity_bitwise_under_ep(runs, shape):
    """``_dist_worker.py:313``: stacked identity tables, the shared
    identity table and none give the same bits, prefill and decode."""
    _, _, got = _each(runs, shape, "layers")
    for r in got:
        assert r["identity_bitwise"]


@meshes
def test_perlayer_tables_match_local_under_ep(runs, shape):
    """``_dist_worker.py:349``: depth-varying per-layer permutation tables
    over weights permuted by them, under the mesh, against the reference's
    table-free local forward (``test_torch_model.py``'s tolerance; the
    reference held 5e-3)."""
    _, refs, got = _each(runs, shape, "layers")
    ref = refs["local_logits"]
    for r in got:
        np.testing.assert_allclose(r["perm_logits"], ref, rtol=RTOL,
                                   atol=ATOL_REL * float(np.abs(ref).max()))
        assert np.array_equal(r["perm_logits"], got[0]["perm_logits"])


@meshes
def test_async_chunks_match_sync_under_ep(runs, shape):
    """``_dist_worker.py:400``: a staged per-layer plan drained one layer a
    chunk on every rank's slots equals the synchronous apply bit for bit;
    the tables agree, the bandwidth is calibrated, and the logits through
    either copy are equal."""
    _, _, got = _each(runs, shape, "async")
    for r in got:
        assert r["layers"] == 2 and r["n_drains"] == 2
        assert r["same_gather"] and r["bitwise"] and r["tables"]
        assert r["calibrated"] and r["logits_equal"]


def test_replica_capacity_reduced_cap_under_ep(runs):
    """``_dist_worker.py:460``: at the capacity factor of the post-split
    peak, the replicated layout drops nothing and the bijective one
    overflows its buffer (four EP ranks, as the reference's)."""
    _, _, got = _each(runs, (1, 4), "capacity")
    for r in got:
        assert r["hot"] > 0.4
        assert r["bij_overflows"]
        assert r["drop_rep"] == 0.0
        assert r["drop_bij"] > 0.0


@pytest.mark.parametrize("arm", list(EP_ARMS))
def test_ep_engine_arm_matches_reference_engine(runs, arm):
    """The EP engine on four ranks against the reference's engine with
    ``virtual_ep = 4``: every rank the same tokens and finish times, every
    ``IterStats`` field, the routable tables after every iteration, the
    AIMD state, the bytes moved and the bytes each gather reported; and
    the bytes the ranks exchanged sum to the bytes the plans moved."""
    _, refs, got = _each(runs, ARMS_MESH, "arms")
    ref = refs["arms"][arm]
    split = EP_ARMS[arm][0] == "replication"
    sent = 0
    for r in (g[arm] for g in got):
        assert r["tokens"] == ref["tokens"]
        assert r["finish"] == ref["finish"]
        assert len(r["stats"]) == len(ref["stats"])
        for i, (a, b) in enumerate(zip(ref["stats"], r["stats"])):
            if split:
                # a replicated expert's tokens go round-robin over its
                # replicas by a counter of each rank's own tokens under EP
                # (as the reference's shard_map path counts them), of all
                # tokens on one device: the split and the rank loads it
                # makes differ, nothing else
                a = {k: v for k, v in a.items() if k not in SPLIT_STATS}
                b = {k: v for k, v in b.items() if k not in SPLIT_STATS}
            assert a == b, (i, a, b)
        assert r["stats"] == got[0][arm]["stats"]
        assert len(r["tables"]) == len(ref["tables"])
        for i, (a, b) in enumerate(zip(ref["tables"], r["tables"])):
            assert all(np.array_equal(np.asarray(x), y)
                       for x, y in zip(a, b)), i
        assert np.array_equal(r["m"], got[0][arm]["m"])
        if not split:           # the AIMD state follows the rank loads
            assert np.array_equal(r["m"], ref["m"])
        assert r["moved"] == ref["moved"] > 0
        assert r["observed"] == ref["observed"]
        assert r["cap"] == ref["cap"]
        assert r["commits"] == ref["commits"] > 0
        sent += r["sent"]
    assert sent == ref["moved"]


def test_ep_engine_checkpoint_equals_reference_engine(runs):
    """After the placement arm, the EP engine's checkpoint holds the same
    arrays as the reference's engine's, byte for byte (the global layout,
    the manager's state), and a reference engine restores it to the same
    weights and tables."""
    _, refs, got = _each(runs, ARMS_MESH, "arms")
    ref = refs["arms"]["placement"]
    tmp = runs[ARMS_MESH][3]
    assert {g["placement"]["saved"] for g in got} == {
        str(tmp / "ep_engine" / "step_00000005")}
    for group in ("serving", "placement"):
        a = np.load(tmp / "ep_engine" / "step_00000005" / f"{group}.npz")
        b = np.load(tmp / "ref_engine" / "step_00000005" / f"{group}.npz")
        assert sorted(a.files) == sorted(b.files), group
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            assert a[k].tobytes() == b[k].tobytes(), k
    eng, mgr = ref["engine"], ref["manager"]
    cfg_j, _, params, _ = tm.model()
    fresh = tm.JEngine(cfg_j, params, JCfg(**OFF), placement=tm.JPM(
        cfg_j, tm.JPCfg(**dict(MCFG, **EP_ARMS["placement"][1])), 4),
        virtual_ep=4, **ENGINE)
    fresh.load_checkpoint(str(tmp / "ep_engine"))
    for a, b in zip(jax.tree.leaves(fresh.params),
                    jax.tree.leaves(eng.params)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    tm.tables_equal(fresh._placement, mgr)

"""Elastic serving under multi-rank expert parallelism: a rank killed,
recovered from the global checkpoint and rejoined, the effective mesh,
``reshard`` and ``shrink_mesh``, and a kill-rejoin serving arm of the EP
engine, on spawned gloo ranks against the reference's local path and
engine.

One spawn a mesh (``_torch_dist.run_ranks``, joined within its deadline)
runs every case (``_torch_ep_workers.elastic_cases``) while the test
process computes the reference.  Counterparts of the reference's mesh
checks (``tests/_dist_worker.py``, which cannot run on this toolchain):

- ``check_elastic_kill_rejoin_under_ep`` (``_dist_worker.py:686``), on a
  ``(1, 4)`` mesh: ``test_kill_*``, ``test_recovery_*``,
  ``test_rejoin_*`` and ``test_effective_mesh_drops_the_dead_rank``;
- ``check_elastic_reshard`` (``:589``), on a ``(2, 2)`` mesh, with the
  logits of ``prefill_forward`` in place of ``train_loss`` (not ported):
  ``test_reshard_*``.

The serving arm: per-layer replica tables drained asynchronously, rank 2
killed at iteration 3 and rejoined at 14, the re-materialization source
the checkpoint the EP engine wrote before serving, against the reference's
engine with ``virtual_ep = 4``.
"""
import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_managers as tm
from _torch_dist import run_ranks
from _torch_ep_workers import elastic_cases
from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core import ep_moe as jmoe
from repro.models import transformer as jtf

OFF = dict(gate_gamma=10 ** 9)
TOL = 5e-5                        # the reference's mesh-vs-local tolerance
ENGINE = dict(max_slots=4, max_len=64, prefill_budget=16)
ARM = ("replication", dict(spare_per_rank=1, max_replicas=2, per_layer=True),
       dict(migrate_async=True))
MCFG = dict(replan_every=4, warmup_iters=2, min_gain=0.0)
FAULTS = [(3, "fail", 2), (14, "rejoin", 2)]
SPLIT_STATS = ("ib_global", "split_frac")    # see test_torch_ep_migrate
N_REQ, MAX_PROMPT = 10, 16
SPR = 3                                      # 8 experts, 4 ranks, 1 spare


def _kill_setup():
    """The reference's ``_moe_setup`` from numpy draws, expert 0 hot."""
    cfg = jreduced(jget("olmoe-1b-7b"))
    d, n_e, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff
    rng = np.random.default_rng(1)
    p = {"router": rng.standard_normal((d, n_e)) * 0.2,
         "w_gate": rng.standard_normal((n_e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((n_e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((n_e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["router"][:, 0] += 4.0
    x = (rng.standard_normal((4, 16, d)) * 0.5).astype(np.float32)
    return cfg, p, x, rng.random((4, 16)) < 0.6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    cfg, p, x, mod = _kill_setup()
    arch = tm.ARCH
    cfg_m, _, params_m, pnum = tm.model()
    tokens = np.random.default_rng(2).integers(
        0, cfg_m.vocab_size, (4, 16)).astype(np.int32)
    for shape in ((1, 4), (2, 2)):
        tmp = tmp_path_factory.mktemp(f"ep_elastic_{shape[0]}x{shape[1]}")
        if shape == (1, 4):
            cases = {"kill": {"p": p, "x": x, "mod": mod,
                              "dir": str(tmp / "kill")},
                     "arm": {"arch": arch, "arm": (ARM[0], dict(
                         MCFG, **ARM[1]), ARM[2]), "params": pnum,
                         "policy": OFF, "engine": ENGINE, "n_req": N_REQ,
                         "max_prompt": MAX_PROMPT, "faults": FAULTS,
                         "ckpt_dir": str(tmp / "port_ckpt")}}
        else:
            cases = {"reshard": {"arch": arch, "params": pnum,
                                 "tokens": tokens, "rcfg": OFF}}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            fut = pool.submit(run_ranks, elastic_cases, shape, cases, tmp)
            refs = {}
            if shape == (1, 4):
                y, _, aux = jmoe.ep_moe_forward(
                    {k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), cfg, JCfg(**OFF), jnp.full((1, 1), 0.9),
                    jnp.asarray(mod), mode="dispatch")
                refs["y"] = np.asarray(y)
                refs["el"] = np.asarray(aux["expert_load"])
                refs["arm"] = tm.ep_ref_arm(
                    ARM, MCFG, OFF, ENGINE, 4, N_REQ, MAX_PROMPT,
                    faults=FAULTS, ckpt_dir=str(tmp / "ref_ckpt"))
            else:
                refs["logits"] = np.asarray(jtf.prefill_forward(
                    params_m, cfg_m, JCfg(**OFF),
                    {"tokens": jnp.asarray(tokens)}, jnp.full((1, 2), 0.9),
                    cache_len=20).logits)
            ranks = fut.result()
        out[shape] = (cases, refs, ranks)
    return out


def _each(runs, shape, case):
    cases, refs, ranks = runs[shape]
    got = [r[case] for r in ranks]
    for i, g in enumerate(got):
        assert not (isinstance(g, dict) and "error" in g), \
            f"rank {i}:\n{g['error']}"
    return refs, got


def test_kill_zeroes_only_the_dead_ranks_slots(runs):
    """Under the mesh the dead rank's process zeroes its own slots and
    every other rank none."""
    _, got = _each(runs, (1, 4), "kill")
    for i, r in enumerate(got):
        assert r["zeroed"] == (i == 2), i
        assert r["kept"] == (i != 2), i


def test_kill_strands_singletons_and_keeps_the_replicated_expert(runs):
    """Experts 4 and 5 are stranded; no live expert routes to the dead rank;
    the hot expert's replica is masked off and its primary survives."""
    _, got = _each(runs, (1, 4), "kill")
    for r in got:
        assert r["lost"] == [4, 5]
        assert r["state_degraded"] == "degraded"
        assert r["live_off_dead"]
        assert r["replica_masked"] == (1, 0)


def test_kill_degraded_layer_drops_no_live_token(runs):
    """Routing is unchanged (the reference's expert loads); every live
    expert's slot loads sum to its expert load; the stranded tokens land on
    the dead rank's zeroed slots and are counted."""
    refs, got = _each(runs, (1, 4), "kill")
    for r in got:
        el, sl = r["el_deg"], r["sl_deg"]
        assert np.array_equal(el, refs["el"])
        for ex, slots in r["live_slots"].items():
            if ex not in (4, 5):
                assert sl[slots].sum() == el[ex], ex
        assert sl[2 * SPR] == el[4] and sl[2 * SPR + 1] == el[5]
        assert r["lost_tokens"] == el[4] + el[5]
        assert np.array_equal(r["y_deg"], got[0]["y_deg"])


def test_effective_mesh_drops_the_dead_rank(runs):
    """The mesh minus the dead ``model`` slice: ``(1, 3)`` over ranks 0, 1,
    3, of which the dead rank's process is no member."""
    _, got = _each(runs, (1, 4), "kill")
    for i, r in enumerate(got):
        assert r["effective"] == (1, 3, [[0, 1, 3]], i != 2), i


def test_recovery_rematerializes_from_the_global_checkpoint(runs):
    """The recovery plan lands through the executor with the lost experts'
    rows patched from the checkpoint the mesh saved: nothing is left to
    recover, rank 2 hosts nothing, the layer is bit for bit the one a
    fresh expansion gives, within the reference's tolerance of its local
    path, and every expert's slot loads cover its load again."""
    refs, got = _each(runs, (1, 4), "kill")
    for i, r in enumerate(got):
        assert r["recovered"] == (False, True, False), i
        assert r["rec_bitwise"], i
        err = float(np.abs(r["y_rec"] - refs["y"]).max())
        assert err < TOL, err
        for ex, slots in r["rec_slots"].items():
            assert r["sl_rec"][slots].sum() == refs["el"][ex], ex
    # the stranded experts' rows come from the checkpoint, on the ranks
    # that now hold their slots
    assert sum(r["patched_bytes"] for r in got) > 0


def test_recovery_exchange_carries_the_plans_crossrank_rows(runs):
    """The recovery gather's rows that cross ranks (the stranded experts
    from the dead rank's zeroed slots among them) are the plan's cross-rank
    slots, each one slot's three slabs."""
    _, got = _each(runs, (1, 4), "kill")
    row = 3 * 4 * _slab_elems()                 # three f32 slabs
    assert sum(r["recovery_sent"] for r in got) \
        == got[0]["recovery_plan_rows"] * row


def _slab_elems():
    cfg = jreduced(jget("olmoe-1b-7b"))
    return cfg.d_model * cfg.moe.d_ff


def test_rejoin_is_routable_only_after_the_warmup_plan_lands(runs):
    refs, got = _each(runs, (1, 4), "kill")
    for r in got:
        assert r["state_warming"] == "warming"
        assert not r["hosts_before"] and not r["staged_hosts"]
        assert r["state_final"] == "healthy" and r["hosts_after"]
        err = float(np.abs(r["y_fin"] - refs["y"]).max())
        assert err < TOL, err


def test_ep_engine_kill_rejoin_arm_matches_reference(runs):
    """Rank 2 killed at iteration 3 and rejoined at 14 in the EP engine and
    the reference's: the same tokens, finish times, ``IterStats`` (the
    replica split's fields aside, as in ``test_torch_ep_migrate``), tables
    after every iteration, coordinator events, the mid-recovery refusal's
    iteration, availability, degraded iterations, recovery seconds and lost
    tokens; the exchanged bytes sum to the bytes moved."""
    refs, got = _each(runs, (1, 4), "arm")
    ref = refs["arm"]
    for r in got:
        assert r["tokens"] == ref["tokens"]
        assert r["finish"] == ref["finish"]
        assert len(r["stats"]) == len(ref["stats"])
        for i, (a, b) in enumerate(zip(ref["stats"], r["stats"])):
            a = {k: v for k, v in a.items() if k not in SPLIT_STATS}
            b = {k: v for k, v in b.items() if k not in SPLIT_STATS}
            assert a == b, (i, a, b)
        assert r["stats"] == got[0]["stats"]
        for i, (a, b) in enumerate(zip(ref["tables"], r["tables"])):
            assert all(np.array_equal(np.asarray(x), y)
                       for x, y in zip(a, b)), i
        assert r["events"] == ref["events"]
        assert r["refused"][0] == ref["refused"][0]
        assert r["summary"] == ref["summary"]
        assert r["moved"] == ref["moved"] > 0
    assert [e["kind"] for e in ref["events"]][:2] == ["fail", "recovered"]
    assert any(s["n_unroutable"] > 0 for s in got[0]["stats"])
    assert any(s["lost_tokens"] > 0 for s in got[0]["stats"])
    assert sum(r["sent"] for r in got) == ref["moved"]


@pytest.mark.parametrize("mesh", ["here", "lost_data_row", "lost_ep_rank",
                                  "other_ep"])
def test_reshard_serves_the_same_logits(runs, mesh):
    """``_dist_worker.py:589``: the host tree placed by ``reshard`` on the
    ``(2, 2)`` mesh, on it minus data row 1 (``(1, 2)``), minus EP rank 0
    (``(2, 1)``) and on a ``(1, 4)`` mesh of the same ranks: every member
    rank's prefill logits within 1e-3 of the reference's local forward;
    ranks outside a shrunk mesh hold nothing."""
    refs, got = _each(runs, (2, 2), "reshard")
    want = {"here": ((2, 2), [[0, 1], [2, 3]]),
            "lost_data_row": ((1, 2), [[0, 1]]),
            "lost_ep_rank": ((2, 1), [[1], [3]]),
            "other_ep": ((1, 4), [[0, 1, 2, 3]])}[mesh]
    members = 0
    for r in got:
        res = r[mesh]
        assert (tuple(res["shape"]), res["ranks"]) == want
        if not res["member"]:
            assert res["logits"] is None
            continue
        members += 1
        err = float(np.abs(res["logits"] - refs["logits"]).max())
        assert err < 1e-3, (mesh, err)
    assert members == want[0][0] * want[0][1]

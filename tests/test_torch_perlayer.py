"""Per-layer tables in the port against the reference: the split of a
per-layer argument, identity per-layer tables bitwise equal to no table in
``prefill_forward``/``chunk_forward``/``decode_forward``, non-identity
per-layer placement and replication tables through all three forwards,
and the ``placement/L`` and ``replicate/L`` serving arms (mirrors
tests/test_perlayer.py, parity where the reference asserts a property)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_managers as tm
from _torch_managers import one_torch_thread  # noqa: F401
from repro.models import transformer as jtf
from repro.replication import planner as jplanner
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.core import ep_moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.placement import PlacementTable
from repro_torch.replication import expand_moe_params as texpand
from repro_torch.replication import planner as tplanner

B, S, L = 2, 12, 32


@pytest.fixture(scope="module")
def model():
    return tm.model()


def test_split_placement_shapes():
    ident = tmoe.identity_replication(8, 4, "cpu")
    shared, stacked = ttf.split_placement(tuple(ident), 3)
    assert stacked is None and len(shared) == 3
    st = tuple(a.expand((3,) + tuple(a.shape)) for a in ident)
    shared, stacked = ttf.split_placement(st, 3)
    assert shared is None and tuple(stacked[0].shape) == (3, 8, 1)
    with pytest.raises(AssertionError):
        ttf.split_placement(st, 4)           # wrong leading axis
    assert ttf.split_placement(None, 3) == (None, None)
    assert ttf.n_physical_slots(
        tm.reduced(tm.get_config(tm.ARCH)),
        st + (torch.zeros((3, 8, 4), dtype=torch.int32),)) == 8


def _forwards(params, cfg, rcfg, place, m, tokens):
    """prefill → decode, and a chunk forward on a fresh cache."""
    b = {"tokens": tokens}
    r = ttf.prefill_forward(params, cfg, rcfg, b, m.clone(), cache_len=L,
                            placement=place)
    d = ttf.decode_forward(params, cfg, rcfg, {
        "tokens": tokens[:, :1], "pos": torch.full((B,), S,
                                                  dtype=torch.int32)},
        r.cache, r.m_state, placement=place)
    c = ttf.chunk_forward(params, cfg, rcfg, {
        "tokens": tokens, "start": torch.zeros(B, dtype=torch.int32),
        "chunk_len": torch.tensor([S, S - 5], dtype=torch.int32)},
        ttf.init_cache(cfg, B, L, "cpu"), m.clone(), placement=place)
    return r, d, c


def test_perlayer_identity_bitwise_full_model(model):
    """Stacked identity tables are bitwise equal to the shared identity
    table and to the table-free path, in all three forwards."""
    _, cfg, _, pnum = model
    params = params_from_numpy(pnum, "cpu")
    rcfg = TCfg(gate_gamma=4)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    m = torch.full((1, 4), 0.9)
    _, n_blocks, _ = ttf.block_structure(cfg)
    ident = tuple(tmoe.identity_replication(cfg.moe.num_experts, 4, "cpu"))
    stacked = tuple(a.expand((n_blocks,) + tuple(a.shape)) for a in ident)
    outs = [_forwards(params, cfg, rcfg, p, m, tokens)
            for p in (None, ident, stacked)]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a.logits, b.logits)
            assert torch.equal(a.m_state, b.m_state)
            for k in ("moe_stats", "expert_stats", "slot_stats"):
                assert torch.equal(a.aux[k], b.aux[k])


def _perlayer_tables(kind, n_blocks, e, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "placement":
        out = [PlacementTable.identity(e, 4)]
        for _ in range(1, n_blocks):
            owner = rng.permutation(e)
            pos = np.empty(e, np.int64)
            pos[owner] = np.arange(e)
            out.append(PlacementTable(pos // (e // 4), pos % (e // 4), 4))
        return out, out
    loads = [np.exp(rng.normal(0, 1.0, e)) for _ in range(n_blocks)]
    return ([jplanner.plan_replication(ld, 4, e // 4 + 1) for ld in loads],
            [tplanner.plan_replication(ld, 4, e // 4 + 1) for ld in loads])


@pytest.mark.parametrize("mode", ["prefill", "chunk", "decode"])
@pytest.mark.parametrize("kind", ["placement", "replication"])
def test_perlayer_tables_match_reference(model, kind, mode):
    """Block ``b`` routes through slice ``b`` of a per-layer table: with
    each block's slab laid out by its own table, routing stats equal the
    reference's and logits agree within the model-level tolerance."""
    cfg_j, cfg_t, params, pnum = model
    kw = dict(gate_gamma=8, md_init=0.0)
    _, n_blocks, _ = ttf.block_structure(cfg_t)
    e = cfg_t.moe.num_experts
    tab_j, tab_t = _perlayer_tables(kind, n_blocks, e)
    tparams = params_from_numpy(pnum, "cpu")
    if kind == "placement":
        own = np.stack([t.owner for t in tab_t])
        moe = tparams["blocks"]["layer0"]["moe"]
        jmoe_p = dict(params["blocks"]["layer0"]["moe"])
        for key in ("w_gate", "w_up", "w_down"):
            idx = torch.from_numpy(own).reshape(own.shape + (1, 1))
            moe[key] = torch.take_along_dim(moe[key], idx, dim=1)
            jmoe_p[key] = jnp.take_along_axis(
                jmoe_p[key], jnp.asarray(own.reshape(own.shape + (1, 1))),
                axis=1)
        params = dict(params, blocks={"layer0": dict(
            params["blocks"]["layer0"], moe=jmoe_p)})
        arrs = (np.stack([t.e2r for t in tab_t]),
                np.stack([t.local_slot for t in tab_t]))
    else:
        from repro.replication import expand_moe_params as jexpand
        params = jexpand(params, tab_j)
        tparams = texpand(tparams, tab_t)
        arrs = (np.stack([r.rep_pos for r in tab_t]),
                np.stack([r.n_rep for r in tab_t]),
                np.stack([r.slot_owner for r in tab_t]))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
    m = np.zeros((1, 4), np.float32)
    place_j = tuple(jnp.asarray(a) for a in arrs)
    place_t = tuple(torch.from_numpy(a) for a in arrs)
    jr, tr = tm.JCfg(**kw), TCfg(**kw)
    if mode in ("prefill", "decode"):
        rj = jax.jit(partial(jtf.prefill_forward, cfg=cfg_j, rcfg=jr,
                             cache_len=L))(
            params, batch={"tokens": jnp.asarray(tokens)},
            m_state=jnp.asarray(m), placement=place_j)
        rt = ttf.prefill_forward(tparams, cfg_t, tr,
                                 {"tokens": torch.from_numpy(tokens)},
                                 torch.from_numpy(m), cache_len=L,
                                 placement=place_t)
        if mode == "decode":
            db = {"tokens": tokens[:, :1], "pos": np.full(B, S, np.int32)}
            rj = jax.jit(partial(jtf.decode_forward, cfg=cfg_j, rcfg=jr))(
                params, batch=jax.tree.map(jnp.asarray, db), cache=rj.cache,
                m_state=rj.m_state, placement=place_j)
            rt = ttf.decode_forward(tparams, cfg_t, tr,
                                    {k: torch.from_numpy(v)
                                     for k, v in db.items()},
                                    rt.cache, rt.m_state, placement=place_t)
    else:
        cb = {"tokens": tokens, "start": np.zeros(B, np.int32),
              "chunk_len": np.array([S, S - 5], np.int32)}
        cache = jtf.init_cache(cfg_j, B, L)
        rj = jax.jit(partial(jtf.chunk_forward, cfg=cfg_j, rcfg=jr))(
            params, batch=jax.tree.map(jnp.asarray, cb), cache=cache,
            m_state=jnp.asarray(m), placement=place_j)
        rt = ttf.chunk_forward(tparams, cfg_t, tr,
                               {k: torch.from_numpy(v) for k, v in cb.items()},
                               cache_from_numpy(jax.tree.map(np.asarray,
                                                             cache), "cpu"),
                               torch.from_numpy(m), placement=place_t)
    for k in ("moe_stats", "expert_stats", "slot_stats"):
        assert np.array_equal(rt.aux[k].numpy(), np.asarray(rj.aux[k])), k
    assert np.array_equal(rt.m_state.numpy(), np.asarray(rj.m_state))
    lj = np.asarray(rj.logits)
    np.testing.assert_allclose(rt.logits.numpy(), lj, rtol=1e-4,
                               atol=3e-5 * float(np.abs(lj).max()))
    if kind == "replication":
        assert float(rt.aux["split_frac"]) == float(rj.aux["split_frac"])


@pytest.mark.parametrize("arm", ["placement/L", "replicate/L"])
def test_engine_perlayer_arm_matches_reference(arm):
    run = tm.run_arm(arm)
    tm.assert_streams_equal(run)
    mgr = run.eng_t._placement
    assert mgr.per_layer and mgr.n_migrations > 0
    # a layer-diff moves fewer bytes than every layer's table changing
    assert (mgr.migrated_bytes_per_layer > 0).sum() >= 1

"""The port's MoE layer (local path) against the reference's
``ep_moe_forward``: dispatch and broadcast, FP4 on and off, over the
identity table and one non-identity replica set.  Routing stats and the
AIMD state are exact; ``y`` is held at the kernels' f32 tolerance."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.core import ep_moe as jmoe
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import ep_moe as tmoe

VEP = 4
FP4 = dict(gate_gamma=8, md_init=0.0, adaptive=False)   # gate open, FP4 fires
BF16 = dict(gate_gamma=10 ** 9)                          # gate closed
AIMD = dict(gate_gamma=8, md_init=0.3)                   # adaptive, FP4 where hot


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one worker per core, and these
    tiny tensors gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed=0, b=2, s=24):
    cfg_j = jreduced(jget("moonshot-v1-16b-a3b"))
    cfg_t = reduced(get_config("moonshot-v1-16b-a3b"))
    e = cfg_j.moe
    d, n_e, f = cfg_j.d_model, e.num_experts, e.d_ff
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, n_e)) * 0.2,
         "w_gate": rng.standard_normal((n_e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((n_e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((n_e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    mod = rng.random((b, s)) < 0.6
    valid = np.ones((b, s), bool)
    valid[1, s - 5:] = False                   # padding tail on one row
    return cfg_j, cfg_t, p, x, mod, valid


def _replication(n_e):
    """Experts 0 and 3 each get a second replica in a spare slot; 12 slots
    over 4 virtual ranks (3 per rank).  Weights in slot order."""
    owner = np.array([0, 1, 3, 2, 4, 0, 5, 6, 3, 7, -1, -1], np.int32)
    rep_pos = np.zeros((n_e, 2), np.int32)
    n_rep = np.ones(n_e, np.int32)
    for e in range(n_e):
        slots = np.flatnonzero(owner == e)
        rep_pos[e] = [slots[0], slots[-1]]
        n_rep[e] = len(slots)
    return rep_pos, n_rep, owner


def _slot_params(p, owner):
    out = dict(p)
    for k in ("w_gate", "w_up", "w_down"):
        out[k] = p[k][np.maximum(owner, 0)]
    return out


def _top_k_margin(p, x, k):
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    srt = np.sort(probs, -1)[:, ::-1]
    return float((srt[:, k - 1] - srt[:, k]).min())


CASES = [(mode, pol, table) for mode in ("dispatch", "broadcast")
         for pol in ("fp4", "bf16", "aimd") for table in ("identity", "rep")]


@pytest.mark.parametrize("mode,pol,table", CASES)
def test_ep_moe_local_matches_reference(mode, pol, table):
    cfg_j, cfg_t, p, x, mod, valid = _setup()
    if mode == "broadcast":            # decode: 12 rows of one token each
        x = x.reshape(-1, 1, x.shape[-1])[-12:]
        mod, valid = mod.reshape(-1, 1)[-12:], valid.reshape(-1, 1)[-12:]
    # exact routing is a fair demand only with a clear top-k margin
    assert _top_k_margin(p, x, cfg_j.moe.top_k) > 1e-5
    kw = {"fp4": FP4, "bf16": BF16, "aimd": AIMD}[pol]
    jr, tr = JCfg(**kw), TCfg(**kw)
    place_j = place_t = None
    if table == "rep":
        rep = _replication(cfg_j.moe.num_experts)
        p = _slot_params(p, rep[2])
        place_j = jmoe.Replication(*(jnp.asarray(a) for a in rep))
        place_t = tmoe.Replication(*(torch.from_numpy(a) for a in rep))
    m = np.full((1, VEP), kw.get("md_init", 0.9), np.float32)
    fn = jax.jit(partial(jmoe.ep_moe_forward, cfg=cfg_j, rcfg=jr, mode=mode))
    y_j, m_j, aux_j = fn({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), m_state=jnp.asarray(m),
                         modality=jnp.asarray(mod), valid=jnp.asarray(valid),
                         placement=place_j)
    y_t, m_t, aux_t = tmoe.ep_moe_forward(
        params_from_numpy(p, "cpu"), torch.from_numpy(x), cfg_t, tr,
        torch.from_numpy(m), torch.from_numpy(mod), mode=mode,
        valid=torch.from_numpy(valid), placement=place_t)

    for k in ("load_d", "vis_d", "slot_load", "slot_vis", "expert_load",
              "expert_vis", "fp4_ranks", "gate_open", "ib_global",
              "drop_frac", "split_frac"):
        a = np.asarray(aux_j[k], np.float32).reshape(-1)
        b = aux_t[k].numpy().astype(np.float32).reshape(-1)
        assert np.array_equal(a, b), (k, a, b)
    assert np.array_equal(np.asarray(m_j), m_t.numpy())
    fired = float(aux_t["fp4_ranks"]) > 0
    assert fired == (pol == "fp4") or pol == "aimd"
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-4)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-5, atol=1e-6)


def test_capacity_drops_match_reference():
    """A tiny capacity factor drops assignments: the dropped fraction and
    the output (dropped rows contribute 0) match."""
    import dataclasses
    cfg_j, cfg_t, p, x, mod, valid = _setup(seed=3, s=32)
    cfg_j = dataclasses.replace(
        cfg_j, moe=dataclasses.replace(cfg_j.moe, capacity_factor=0.3))
    cfg_t = dataclasses.replace(
        cfg_t, moe=dataclasses.replace(cfg_t.moe, capacity_factor=0.3))
    m = np.zeros((1, VEP), np.float32)
    y_j, _, aux_j = jax.jit(partial(jmoe.ep_moe_forward, cfg=cfg_j,
                                    rcfg=JCfg(**FP4)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        m_state=jnp.asarray(m), modality=jnp.asarray(mod),
        valid=jnp.asarray(valid))
    y_t, _, aux_t = tmoe.ep_moe_forward(
        params_from_numpy(p, "cpu"), torch.from_numpy(x), cfg_t,
        TCfg(**FP4),
        torch.from_numpy(m), torch.from_numpy(mod),
        valid=torch.from_numpy(valid))
    assert float(aux_t["drop_frac"]) > 0
    assert float(aux_t["drop_frac"]) == float(aux_j["drop_frac"])
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-4)


def test_top_k_ties_break_to_lower_index():
    """jax.lax.top_k order on ties (a zero padding row routes uniformly)."""
    probs = torch.full((2, 8), 0.125)
    probs[1, 5] = 0.5
    _, idx = tmoe._top_k(probs, 3)
    _, ref = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert np.array_equal(idx.numpy(), np.asarray(ref))


def test_occurrence_index_matches_reference():
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 9, 200).astype(np.int32)
    ref = jax.jit(jmoe._occurrence_index, static_argnums=1)(
        jnp.asarray(flat), 8)
    assert np.array_equal(np.asarray(ref), tmoe._occurrence_index(
        torch.from_numpy(flat), 8).numpy())


def test_placement_table_normalizes_like_reference():
    perm = np.array([2, 0, 3, 1, 1, 3, 0, 2], np.int32)    # e2r
    slot = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.int32)
    ref = jmoe._as_replication(jmoe.Placement(jnp.asarray(perm),
                                              jnp.asarray(slot)), 8, 4)
    got = tmoe._as_replication(tmoe.Placement(torch.from_numpy(perm),
                                              torch.from_numpy(slot)), 8, 4,
                               "cpu")
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())
    ident = tmoe._as_replication(tmoe.identity_placement(8, 4), 8, 4, "cpu")
    for a, b in zip(tmoe.identity_replication(8, 4), ident):
        assert torch.equal(a, b)


SEQ = dict(FP4, overlap=False)                 # ReaLB-seq, FP4 fires


@pytest.mark.parametrize("table", ["identity", "rep"])
def test_realb_seq_matches_reference(table):
    """``overlap=False`` (ReaLB-seq): the quantizer runs after the dispatch
    with the reference's ``recv.sum() * 0.0`` dependency; FP4 on, routing
    stats and the AIMD state exact, ``y`` at the kernels' f32 tolerance,
    and the same result as ReaLB (``overlap=True``) on finite tokens."""
    cfg_j, cfg_t, p, x, mod, valid = _setup(seed=5)
    place_j = place_t = None
    if table == "rep":
        rep = _replication(cfg_j.moe.num_experts)
        p = _slot_params(p, rep[2])
        place_j = jmoe.Replication(*(jnp.asarray(a) for a in rep))
        place_t = tmoe.Replication(*(torch.from_numpy(a) for a in rep))
    m = np.zeros((1, VEP), np.float32)
    fn = jax.jit(partial(jmoe.ep_moe_forward, cfg=cfg_j, rcfg=JCfg(**SEQ)))
    y_j, m_j, aux_j = fn({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), m_state=jnp.asarray(m),
                         modality=jnp.asarray(mod), valid=jnp.asarray(valid),
                         placement=place_j)
    args = (params_from_numpy(p, "cpu"), torch.from_numpy(x), cfg_t)
    kw = dict(m_state=torch.from_numpy(m), modality=torch.from_numpy(mod),
              valid=torch.from_numpy(valid), placement=place_t)
    y_t, m_t, aux_t = tmoe.ep_moe_forward(*args, TCfg(**SEQ), **kw)
    y_o, m_o, _ = tmoe.ep_moe_forward(*args, TCfg(**FP4), **kw)
    assert float(aux_t["fp4_ranks"]) > 0
    for k in ("load_d", "vis_d", "slot_load", "expert_load", "fp4_ranks",
              "gate_open", "ib_global", "drop_frac", "split_frac"):
        assert np.array_equal(np.asarray(aux_j[k], np.float32).reshape(-1),
                              aux_t[k].numpy().astype(np.float32)
                              .reshape(-1)), k
    assert np.array_equal(np.asarray(m_j), m_t.numpy())
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-4)
    assert torch.equal(y_t, y_o) and torch.equal(m_t, m_o)


@pytest.mark.parametrize("token", [0.0, float("nan")], ids=["zero", "nan"])
def test_realb_seq_token_quantizes_like_reference(token):
    """The ReaLB-seq token is a real add before the global scale and the
    quantizer: codes and scales equal the reference's on weights holding
    -0.0 (the E2M1 encoder takes the sign from ``x < 0``, so -0.0 and the
    +0.0 the add makes give one code, as without the token) and under a
    NaN token (dispatched tokens holding an inf)."""
    cfg_j, _, p, *_ = _setup(seed=6)
    w = {n: p[n].copy() for n in ("w_gate", "w_up", "w_down")}
    for a in w.values():
        a[:, :3, :5] = -0.0
    rq = jax.jit(jmoe._quantize_experts, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(True),
        JCfg(**SEQ), jnp.asarray(np.float32(token)))
    tw = params_from_numpy(w, "cpu")
    one = torch.ones((), dtype=torch.int32)
    tq = tmoe._quantize_experts(tw, TCfg(**SEQ), one,
                                torch.tensor(token, dtype=torch.float32))
    plain = tmoe._quantize_experts(tw, TCfg(**SEQ), one)
    for n in w:
        assert np.array_equal(np.asarray(rq[n].packed), tq[n].packed.numpy())
        assert np.array_equal(np.asarray(rq[n].scales), tq[n].scales.numpy(),
                              equal_nan=True)
        assert np.array_equal(np.asarray(rq[n].global_scale),
                              tq[n].global_scale.numpy(), equal_nan=True)
        if token == 0.0:
            assert torch.equal(tq[n].packed, plain[n].packed), n
        else:
            assert torch.isnan(tq[n].global_scale), n


@pytest.mark.parametrize("overlap", [True, False], ids=["realb", "realb_seq"])
def test_inf_token_gives_non_finite_output_in_both(overlap):
    """An inf in a dispatched token: non-finite output in both packages
    (under ReaLB-seq the token turns NaN and poisons the FP4 weights)."""
    cfg_j, cfg_t, p, x, mod, valid = _setup(seed=7)
    x = x.copy()
    x[0, 2, 5] = np.inf
    kw = dict(FP4, overlap=overlap)
    m = np.zeros((1, VEP), np.float32)
    y_j, _, _ = jax.jit(partial(jmoe.ep_moe_forward, cfg=cfg_j,
                                rcfg=JCfg(**kw)))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        m_state=jnp.asarray(m), modality=jnp.asarray(mod),
        valid=jnp.asarray(valid))
    y_t, _, _ = tmoe.ep_moe_forward(
        params_from_numpy(p, "cpu"), torch.from_numpy(x), cfg_t, TCfg(**kw),
        torch.from_numpy(m), torch.from_numpy(mod),
        valid=torch.from_numpy(valid))
    fin_j = np.isfinite(np.asarray(y_j))
    fin_t = np.isfinite(y_t.numpy())
    assert not fin_j.all() and not fin_t.all()
    if not overlap:       # NaN weights reach every routed token
        assert np.array_equal(fin_j, fin_t)

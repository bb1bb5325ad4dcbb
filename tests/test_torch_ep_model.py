"""The port's model stack, serving engine and serving driver under
multi-rank expert parallelism, against the reference's local (one-device)
forwards and engine.

Reduced moonshot-v1-16b-a3b (4 layers, d 128, 8 experts top-2, f32) on
``(1, 2)`` and ``(1, 4)`` meshes of spawned gloo ranks (``_torch_dist``,
joined within its deadline), one spawn a mesh running every case
(``_torch_ep_workers.model_cases``): ``chunk_forward`` then
``decode_forward`` with the gate closed and with the AIMD state adapting
(FP4 off: under a mesh each rank quantizes its own slab, which the local
path does not), held against the reference's jitted forwards over the
virtual topology of the same size at ``test_torch_model.py``'s tolerance,
routing stats and ``m_state`` exact; the model forward's collective
census against the ledger's prediction; a rank's init equal to its slice
of the whole model's; the EP engine on a 16-token-prompt stream against
the reference's engine with ``virtual_ep = ep``: the same tokens, request
times and ``IterStats`` on every rank.  On the same ranks, reduced
jamba-1.5-large-398b (attention, Mamba and MoE layers; the gate closed):
``prefill_forward`` then ``decode_forward`` against the port's one-device
forwards over the virtual topology of the EP size, the equality the
reference asserts of its EP layer (within 5e-5; statistics and
``m_state`` exact), with the SSM weights whole on every rank.  Then
``python -m repro_torch.launch.serve --mesh host --device cpu`` on two
ranks.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_ep_workers import model_cases, serve_case
from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro.workloads import IterationCostModel, VirtualClock
import torch

from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.obs.ledger import FlopByteLedger
from repro_torch.workloads import arrivals as t_arrivals
from repro_torch.workloads import multimodal as t_multimodal

ARCH = "moonshot-v1-16b-a3b"
B, S, L = 4, 16, 64
RTOL, ATOL_REL = 1e-4, 3e-5          # test_torch_model.py's, and why
MESHES = [(1, 2), (1, 4)]
POLICIES = {"bf16": dict(gate_gamma=10 ** 9, md_init=0.5),
            "aimd": dict(gate_gamma=16, md_init=0.5, enabled=False)}
ENGINE = dict(max_slots=4, max_len=64, prefill_budget=16)
ENGINE_POLICY = dict(gate_gamma=10 ** 9)                 # the gate closed
N_REQ, MAX_PROMPT = 6, 16
HYBRID = "jamba-1.5-large-398b"
HYBRID_POLICY = dict(gate_gamma=10 ** 9, md_init=0.5)
HYBRID_TOL = 5e-5                    # of max |one-device|


def _hybrid_case():
    """Reduced jamba's weights (the port's init, as numpy) and inputs: a
    prefill of 3 x 12 tokens into 16 rows, then a decode with an idle
    row."""
    cfg = reduced(get_config(HYBRID))
    params = ttf.init_model(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    b, s = 3, 12
    return {"arch": HYBRID, "rcfg": HYBRID_POLICY, "cache_len": 16,
            "params": _numpy(params),
            "ssm_w_in_shape": tuple(
                params["blocks"]["layer1"]["ssm"]["w_in"].shape),
            "prefill": {"tokens": rng.integers(0, cfg.vocab_size, (b, s))
                        .astype(np.int32),
                        "modality": rng.random((b, s)) < 0.6},
            "decode": {"tokens": rng.integers(0, cfg.vocab_size, (b, 1))
                       .astype(np.int32),
                       "pos": np.array([s, 16, s], np.int32),
                       "modality": np.array([[True], [False], [False]]),
                       "valid": np.array([[True], [False], [True]])}}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy().copy()


def _hybrid_local(case, ep):
    """The port's one-device forwards of the hybrid case over the virtual
    topology of ``ep`` ranks."""
    cfg = reduced(get_config(HYBRID))
    params = params_from_numpy(case["params"], "cpu")
    rcfg = TCfg(**case["rcfg"])
    t = {k: torch.from_numpy(v) for k, v in case["prefill"].items()}
    pre = ttf.prefill_forward(params, cfg, rcfg, t,
                              torch.full((1, ep), rcfg.md_init),
                              cache_len=case["cache_len"])
    out = {"prefill": (pre.logits.numpy(), pre.m_state.numpy(),
                       {k: v.numpy() for k, v in pre.aux.items()},
                       _numpy(pre.cache))}
    d = {k: torch.from_numpy(v) for k, v in case["decode"].items()}
    dec = ttf.decode_forward(params, cfg, rcfg, d, pre.cache, pre.m_state)
    out["decode"] = (dec.logits.numpy(), dec.m_state.numpy(),
                     {k: v.numpy() for k, v in dec.aux.items()},
                     _numpy(dec.cache))
    return out


def _inputs(cfg):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    chunk = {"tokens": tokens,
             "start": np.array([0, 3, 0, 0], np.int32),
             "chunk_len": np.array([16, 10, 0, 5], np.int32),
             "modality": rng.random((B, S)) < 0.6}
    dec = {"tokens": tokens[:, :1],
           "pos": np.array([16, 13, L, 5], np.int32),
           "modality": np.array([[True], [False], [False], [True]]),
           "valid": np.array([[True], [True], [False], [True]])}
    return chunk, dec


def _requests(cfg):
    specs = t_multimodal.make_stream(
        t_multimodal.profile("MMMU"),
        t_arrivals.arrival_times(t_arrivals.ArrivalConfig(
            kind="poisson", rate=40.0, n_requests=N_REQ, seed=0)),
        cfg.vocab_size, seed=1, max_prompt=MAX_PROMPT)
    return [(s.tokens, s.modality, s.max_new_tokens) for s in specs]


def _ref_forwards(params, cfg, kw, chunk, dec, ep):
    m = np.full((1, ep), kw["md_init"], np.float32)
    jr = JCfg(**kw)
    res = jax.jit(partial(jtf.chunk_forward, cfg=cfg, rcfg=jr))(
        params, batch=jax.tree.map(jnp.asarray, chunk),
        cache=jtf.init_cache(cfg, B, L), m_state=jnp.asarray(m))
    d = jax.jit(partial(jtf.decode_forward, cfg=cfg, rcfg=jr))(
        params, batch=jax.tree.map(jnp.asarray, dec), cache=res.cache,
        m_state=res.m_state)
    return {"chunk": jax.tree.map(np.asarray, (res.logits, res.m_state,
                                               res.aux, res.cache)),
            "decode": jax.tree.map(np.asarray, (d.logits, d.m_state, d.aux,
                                                d.cache)),
            "m": m}


def _ref_engine(params, cfg, requests, ep):
    eng = JEngine(cfg, params, JCfg(**ENGINE_POLICY), clock=VirtualClock(),
                  cost_model=IterationCostModel(), virtual_ep=ep, **ENGINE)
    for uid, (toks, mod, new) in enumerate(requests):
        eng.submit(JRequest(uid=uid, tokens=np.asarray(toks, np.int32),
                            modality=np.asarray(mod, bool),
                            max_new_tokens=new, arrival_time=0.0))
    done = eng.run()
    return {"tokens": {r.uid: list(r.generated) for r in done},
            "times": {r.uid: (r.first_token_time, r.finish_time)
                      for r in done},
            "stats": [dataclasses.asdict(s) for s in eng.stats],
            "m": np.asarray(eng.m_state)}


@pytest.fixture(scope="module")
def reference():
    cfg = jreduced(jget(ARCH))
    params = jtf.init_model(cfg, jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module", params=MESHES,
                ids=[f"{r}x{m}" for r, m in MESHES])
def ep_model(request, reference, tmp_path_factory):
    cfg, params, np_params = reference
    ep = request.param[1]
    chunk, dec = _inputs(cfg)
    requests = _requests(cfg)
    refs = {name: _ref_forwards(params, cfg, kw, chunk, dec, ep)
            for name, kw in POLICIES.items()}
    case = {"arch": ARCH, "params": np_params, "policies": POLICIES,
            "chunk": chunk, "decode": dec,
            "cache": jax.tree.map(np.asarray, jtf.init_cache(cfg, B, L)),
            "m": np.full((1, ep), 0.5, np.float32), "odd_len": 5,
            "engine": ENGINE, "engine_rcfg": ENGINE_POLICY,
            "requests": requests, "hybrid": _hybrid_case()}
    ranks = run_ranks(model_cases, request.param, case,
                      tmp_path_factory.mktemp("ep_model"))
    for i, r in enumerate(ranks):
        assert "error" not in r, f"rank {i}:\n{r.get('error')}"
    return (request.param, refs, ranks,
            _ref_engine(params, cfg, requests, ep),
            _hybrid_local(case["hybrid"], ep))


def _compare(j, t, what):
    np.testing.assert_allclose(t, j, err_msg=what, rtol=RTOL,
                               atol=ATOL_REL * float(np.abs(j).max()))


@pytest.mark.parametrize("policy", list(POLICIES))
def test_chunk_then_decode_match_local_under_ep(ep_model, policy):
    _, refs, ranks, _, _ = ep_model
    ref = refs[policy]
    for r in ranks:
        for step in ("chunk", "decode"):
            logits, m_state, aux, cache = ref[step]
            got = r[policy][step]
            _compare(logits, got["logits"], f"{step} logits")
            assert np.array_equal(m_state, got["m"]), step
            keys = ("moe_stats", "expert_stats", "slot_stats") \
                if step == "chunk" else ("moe_stats",)
            for k in keys:
                assert np.array_equal(aux[k], got["aux"][k]), (step, k)
            for group in ("prefix", "blocks"):
                for layer, kv in cache[group].items():
                    for n in ("k", "v"):
                        _compare(kv[n], got["cache"][group][layer][n],
                                 f"{group}/{layer}/{n} after {step}")


def test_ranks_agree_bitwise(ep_model):
    """Every rank returns the same logits and state (the layout gathers
    the MoE output; everything else is replicated)."""
    _, _, ranks, _, _ = ep_model
    for r in ranks[1:]:
        for pol in POLICIES:
            for step in ("chunk", "decode"):
                assert np.array_equal(r[pol][step]["logits"],
                                      ranks[0][pol][step]["logits"])


def test_model_census_matches_prediction(ep_model):
    """A chunk forward's collectives: the ledger's prediction for its MoE
    layers (each rank dispatches B·S/ep tokens)."""
    (rows, ep), _, ranks, _, _ = ep_model
    cfg = reduced(get_config(ARCH))
    n_moe = sum(1 for f in cfg.ffn_kinds() if f == "moe")
    pred = FlopByteLedger(cfg, ep=ep).predict_graph_census(
        t_local=B * S // ep, layers=n_moe, itemsize=4)
    for r in ranks:
        for pol in POLICIES:
            assert r[pol]["chunk"]["census"] == pred


def test_init_model_builds_only_the_rank_shard(ep_model):
    (_, ep), _, ranks, _, _ = ep_model
    cfg = reduced(get_config(ARCH))
    for r in ranks:
        assert r["init_slots"] == cfg.moe.num_experts // ep
        assert r["init_shard"]


def test_chunk_must_divide_over_ep(ep_model):
    for r in ep_model[2]:
        assert "does not divide" in r["odd_chunk"], r["odd_chunk"]


def test_ep_engine_matches_reference_engine(ep_model):
    """Same tokens, request times, IterStats and AIMD state on every rank
    as the reference's engine over the virtual topology of the EP size."""
    _, _, ranks, ref, _ = ep_model
    for r in ranks:
        eng = r["engine"]
        assert eng["tokens"] == ref["tokens"]
        assert eng["times"] == ref["times"]
        assert len(eng["stats"]) == len(ref["stats"])
        for i, (a, b) in enumerate(zip(ref["stats"], eng["stats"])):
            assert a == b, (i, a, b)
        assert np.array_equal(eng["m"], ref["m"])
    assert any(s["phase"] == "decode" for s in ref["stats"])


def test_hybrid_forwards_match_one_device_under_ep(ep_model):
    """Reduced jamba's prefill and decode under the mesh equal the port's
    one-device forwards; every rank holds the whole SSM weights and gives
    the same logits."""
    _, _, ranks, _, local = ep_model
    for r in ranks:
        h = r["hybrid"]
        assert h["ssm_whole"]
        for step in ("prefill", "decode"):
            logits, m_state, aux, cache = local[step]
            got = h[step]
            err = np.abs(got["logits"] - logits).max()
            assert err <= HYBRID_TOL * np.abs(logits).max(), (step, err)
            assert np.array_equal(m_state, got["m"]), step
            for k in ("moe_stats", "expert_stats", "slot_stats"):
                assert np.array_equal(aux[k], got["aux"][k]), (step, k)
            for layer, entries in cache["blocks"].items():
                for n, v in entries.items():
                    e = np.abs(got["cache"]["blocks"][layer][n] - v).max()
                    assert e <= HYBRID_TOL * max(np.abs(v).max(), 1e-30), \
                        (step, layer, n, e)
        assert np.array_equal(h["decode"]["logits"],
                              ranks[0]["hybrid"]["decode"]["logits"])


def test_serve_mesh_host_on_two_cpu_ranks(tmp_path):
    """``python -m repro_torch.launch.serve --mesh host --device cpu`` under
    two spawned gloo ranks: both serve, rank 0 reports, the ranks agree."""
    out = run_ranks(serve_case, (1, 2),
                    ["--preset", "tiny", "--device", "cpu", "--mesh", "host",
                     "--requests", "4", "--max-new", "4"], tmp_path)
    (rc0, text0), (rc1, text1) = out
    assert rc0 == 0 and rc1 == 0
    lines = text0.splitlines()
    assert lines[0].startswith("served 4 requests, ") \
        and "+ 16 generated tokens" in lines[0], lines
    assert lines[-1] == ("mesh 1x2 (gloo): every rank generated the same "
                         "tokens: True"), lines
    assert text1 == ""

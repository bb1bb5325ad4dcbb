"""The tensor-parallel layout of the dense part and the cache under a
``(data, model)`` mesh (``models.layout``, the default rules) against the
port's one-device forwards, engine and training step, which the other
files hold against the reference.

One spawn of four gloo ranks (``_torch_ep_workers.tp_cases``) runs every
case on the ``(2, 2)`` mesh and on a ``(1, 2)`` mesh of two of its ranks,
with reduced f32 configs (the MoE layers' capacity factor 8, so nothing
drops, the load-balance losses off: they are defined per EP group, and
the gate closed):

* reduced moonshot-v1-16b-a3b: a prefill, a chunk (an idle row among
  them) and a decode step; reduced jamba-1.5-large-398b (its Mamba and
  attention layers cut over ``d_inner`` and ``heads``); reduced
  minicpm3-4b (MLA's decode over the latent cut over ``kv_seq``);
  reduced llama-3.2-vision-90b (cross-attention to the vision memory).
  Each data row is its own EP group, so the one-device reference runs a
  data row's rows at a time over the virtual topology of the ``model``
  size.  The logits within the larger of 5e-5 of max |one-device| (the
  tolerance of the port's EP model tests, the reference's 5e-5 of
  ``tests/_dist_worker.py`` taken relative) and 4x the one-device
  forward's own change when its embedding moves by two f32 ulps (a
  random stack's conditioning, ``tests/_torch_arch.py``'s rule: one row
  of reduced llama-vision's prefill moves by several times the first
  term under it); ``m_state`` and the routing counts equal;
* the engine's stream of six requests (moonshot's chunked prefill, and
  minicpm3's one-shot prefill, whose batch-of-one cache the rules cut
  otherwise than the engine's): the same tokens, and on ``(1, 2)`` (one
  EP group) the same ``m_state``;
* a train step: the loss at the model tolerance, every gradient leaf
  (gathered whole) within test_torch_train_mesh.py's spread bound;
* on ``(2, 2)``, the parameters saved under the mesh and restored on one
  device equal, leaf for leaf, the one-device init of the same seed, and
  restored onto the mesh its own slices.

Tensor-parallel partial sums change the order of summation, so nothing
here is bitwise except the statistics, the tokens and the checkpoint.
"""
import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_ep_workers import _tp_cfg, tp_cases
from repro_torch.workloads import arrivals as t_arrivals
from repro_torch.workloads import multimodal as t_multimodal

TOL = 5e-5                           # of max |one-device|
RTOL = 1e-5                          # the loss
ATOL_REL, SPREAD = 3e-5, 4.0         # test_torch_train_mesh.py's
B = 4
ENGINE = dict(max_slots=4, max_len=64, prefill_budget=16)
N_REQ, MAX_PROMPT = 6, 16


def _steps(arch, rng, vision=False, chunk=False):
    cfg = _tp_cfg(arch)
    v = cfg.vocab_size
    s = 16
    pre = {"tokens": rng.integers(0, v, (B, s)).astype(np.int32),
           "modality": rng.random((B, s)) < 0.5}
    if vision:
        pre["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    steps = [{"batch": pre, "cache_len": 32}]
    pos = np.full(B, s, np.int32)
    if chunk:
        n = np.array([8, 5, 0, 8], np.int32)
        steps.append({"batch": {
            "tokens": rng.integers(0, v, (B, 8)).astype(np.int32),
            "start": pos.copy(), "chunk_len": n,
            "modality": rng.random((B, 8)) < 0.5}})
        pos = pos + n
    for _ in range(2):
        steps.append({"batch": {
            "tokens": rng.integers(0, v, (B, 1)).astype(np.int32),
            "pos": pos.copy(), "modality": rng.random((B, 1)) < 0.5,
            "valid": np.array([[True], [True], [False], [True]])}})
        pos = pos + 1
    return {"arch": arch, "steps": steps}


def _requests(cfg):
    specs = t_multimodal.make_stream(
        t_multimodal.profile("MMMU"),
        t_arrivals.arrival_times(t_arrivals.ArrivalConfig(
            kind="poisson", rate=40.0, n_requests=N_REQ, seed=0)),
        cfg.vocab_size, seed=1, max_prompt=MAX_PROMPT)
    return [(sp.tokens, sp.modality, sp.max_new_tokens) for sp in specs]


def _census_case(arch, rng):
    steps = _steps(arch, rng, chunk=True)["steps"]
    chunk = dict(steps[1]["batch"], start=np.zeros(B, np.int32))
    return {"arch": arch, "cache_len": 64, "chunk": chunk,
            "decode": dict(steps[2]["batch"], pos=chunk["chunk_len"])}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    rng = np.random.default_rng(7)
    arch = "moonshot-v1-16b-a3b"
    cfg = _tp_cfg(arch)
    tokens = rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
    labels = tokens.copy()
    labels[:, ::4] = -1
    case = {
        "forwards": {
            "moonshot": _steps(arch, rng, chunk=True),
            "jamba": _steps("jamba-1.5-large-398b", rng),
            "minicpm3": _steps("minicpm3-4b", rng),
            "vlm": _steps("llama-3.2-vision-90b", rng, vision=True)},
        "engine": {"arch": arch, "engine": ENGINE,
                   "requests": _requests(cfg)},
        # MLA prefills one-shot: a batch of one, whose cache rows the
        # rules cut over data x model, inserted into the engine's slot
        "oneshot": {"arch": "minicpm3-4b", "engine": ENGINE,
                    "requests": _requests(_tp_cfg("minicpm3-4b"))},
        "train": {"arch": arch, "batch": {"tokens": tokens,
                                          "labels": labels}},
        "ckpt": {"arch": arch, "dir": str(tmp_path_factory.mktemp("tp"))},
        "census": _census_case(arch, rng)}
    out = run_ranks(tp_cases, (2, 2), case, tmp_path_factory.mktemp("tpr"),
                    rules={})
    for i, r in enumerate(out):
        assert "error" not in r, f"rank {i}:\n{r.get('error')}"
    return out


MESHES = ["2x2", "1x2"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ["moonshot", "jamba", "minicpm3", "vlm"])
def test_forwards_match_one_device(ranks, mesh, arch):
    """Prefill, chunk and decode logits within ``TOL`` of the one-device
    forwards on every rank; each data row's ``m_state`` and the routing
    counts (summed over the rows) equal."""
    n = 4 if mesh == "2x2" else 2
    for r in ranks[:n]:
        res = r[mesh][arch]
        for i, got in enumerate(res["got"]):
            ref = [rows[i] for rows in res["ref"]]
            want = np.concatenate([x["logits"] for x in ref])
            spread = max(np.abs(np.concatenate(
                [moved[j][i] for moved in res["moved"]]) - want).max()
                for j in range(2))
            err = np.abs(got["logits"] - want).max()
            bound = max(TOL * np.abs(want).max(), SPREAD * spread)
            assert err <= bound, (arch, i, err, bound)
            for g, x in enumerate(ref):
                np.testing.assert_array_equal(got["m"][g], x["m"][0])
            np.testing.assert_array_equal(got["experts"],
                                          sum(x["experts"] for x in ref))
            np.testing.assert_array_equal(got["slots"],
                                          sum(x["slots"] for x in ref))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", ["engine", "oneshot"])
def test_engine_stream_matches_one_device(ranks, mesh, case):
    """The same tokens for every request on every rank as the one-device
    engine (chunked prefill; MLA's one-shot prefill, whose cache goes into
    the engine's cache in its layout); with one EP group the same AIMD
    state at the end."""
    n = 4 if mesh == "2x2" else 2
    for r in ranks[:n]:
        res = r[mesh][case]
        assert res["got"]["tokens"] == res["ref"]["tokens"]
        assert len(res["got"]["tokens"]) == N_REQ
        if mesh == "1x2":
            np.testing.assert_array_equal(res["got"]["m"], res["ref"]["m"])


@pytest.mark.parametrize("mesh", MESHES)
def test_train_step_within_spread(ranks, mesh):
    """A train step's loss at the model tolerance and every gradient leaf
    within the larger of ``ATOL_REL`` x its max and ``SPREAD`` x the
    one-device step's own change when the embedding moves by two f32
    ulps (training's conditioning, test_torch_train_mesh.py)."""
    n = 4 if mesh == "2x2" else 2
    for r in ranks[:n]:
        res = r[mesh]["train"]
        (loss, ref), (_, up), (_, down) = res["ref"]
        assert abs(res["loss"] - loss) <= RTOL * abs(loss)
        for key, want in ref.items():
            spread = max(np.abs(up[key] - want).max(),
                         np.abs(down[key] - want).max())
            bound = max(ATOL_REL * np.abs(want).max(), SPREAD * spread)
            err = np.abs(res["grads"][key] - want).max()
            assert err <= bound, (key, err, bound)


def test_checkpoint_round_trip(ranks):
    """Saved on ``(2, 2)``, restored on one device and onto the mesh: the
    same bits."""
    for r in ranks:
        assert r["2x2"]["ckpt"] == {"restored": True, "recut": True}


def test_census_and_counts_match_meta_and_prediction(ranks):
    """On ``(2, 2)`` the chunk and decode steps' census on every rank is
    ``predict_graph_census``'s in the layout, and rank 0's analyzer counts
    (flops, traffic, the memory record, the census, aten ops) equal those
    of the same steps on ``meta`` under the abstract ``(2, 2)`` mesh: the
    collectives' transport is not counted."""
    import torch
    from repro_torch.configs import ReaLBConfig
    from repro_torch.launch.steps import analyze_step
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import Mesh, use_mesh
    from repro_torch.obs.ledger import FlopByteLedger
    arch = "moonshot-v1-16b-a3b"
    cfg = _tp_cfg(arch)
    rng = np.random.default_rng(7)
    case = _census_case(arch, rng)
    mesh = Mesh((2, 2), "abstract", "meta")
    rcfg = ReaLBConfig(gate_gamma=10 ** 9, md_init=0.5)
    with use_mesh(mesh, rules={}):
        params = tf.abstract_model(cfg)
        cache = tf.abstract_cache(cfg, B, case["cache_len"])
        m = torch.zeros((2, 2), device="meta")
        for name, fwd in (("chunk", tf.chunk_forward),
                          ("decode", tf.decode_forward)):
            seq = case[name]["tokens"].shape[1] if name == "chunk" else 1
            pred = FlopByteLedger(cfg, ep=2).predict_graph_census(
                0, 0, layout=dict(mesh=mesh, mode=name, batch=B, seq=seq,
                                  cache_len=case["cache_len"]))
            batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(
                np.asarray(v)).dtype, device="meta")
                for k, v in case[name].items()}
            _, an, mem = analyze_step(
                lambda p, ca, mm, bt: fwd(p, cfg, rcfg, bt, ca, mm),
                [params, cache, m, batch], mesh)
            for r in ranks:
                assert r["2x2"]["census"][name]["census"] == pred, name
            got = ranks[0]["2x2"]["census"][name]
            assert (got["flops"], got["traffic"], got["memory"],
                    got["census"], got["ops"]) == (
                an.flops, int(an.traffic), mem, an.census, an.n_ops), name

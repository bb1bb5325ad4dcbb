"""The compiled serving step on the CPU: the in-place KV cache write
against the functional one and the reference's scatter, bit for bit; the
engine's static-buffer step (the code a card captures, run uncaptured
here) against the reference's engine, and with emulated graphs against
itself uncaptured, across a placement commit, a replica refresh, a rank's
kill and rejoin and a checkpoint load; the graph bookkeeping (keys,
replays, drops and recaptures, the sentinel's capture counts, a failing
capture) with CUDA graphs emulated by a replay that re-runs the captured
step on the tensors it was captured over; a forward's seconds taken to
its outputs on the host; and the device-side working-launch counter."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_managers as tm
from _torch_managers import one_torch_thread  # noqa: F401
from repro.models import attention as jattn
from repro.runtime.fault_tolerance import FaultInjector as JFI
from repro.serving.elastic import ElasticCoordinator as JCo
from repro_torch.analysis import Sentinel
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.runtime.fault_tolerance import FaultInjector
from repro_torch.serving import graphs as tgraphs
from repro_torch.serving.elastic import ElasticCoordinator

L = 12                                   # cache rows of the write cases
CFG = tm.reduced(tm.get_config(tm.ARCH))  # reduced moonshot: K, D of a row
K, D = CFG.n_kv_heads, CFG.head_dim


# --------------------------------------------------------------------------
# the in-place cache write
# --------------------------------------------------------------------------
# (start [B], chunk_len [B], S): each row writes [start, start + chunk_len)
CHUNK_CASES = {
    "idle_row": ([0, 3, 5], [4, 0, 2], 4),
    "last_valid_at_L-1": ([L - 4, 2, L - 1], [4, 3, 1], 8),
    "padding_past_L": ([L - 2, 0], [2, 8], 8),
    "bucket_past_L": ([0, 3], [L, 2], 16),
    "whole_cache": ([0, 0], [L, 0], L),
    "all_idle": ([0, 7], [0, 0], 8),
}
# pos [B]: L (= max_len) is a slot that is not ready, its write dropped
DECODE_CASES = {
    "dropped": [L, 3, L, 0],
    "edges": [0, L - 1, 5, L - 1],
    "all_dropped": [L, L],
}


def _bits(t):
    t = torch.as_tensor(np.asarray(t)) if not isinstance(t, torch.Tensor) \
        else t
    return t.view(torch.int16) if t.dtype == torch.bfloat16 \
        else t.view(torch.int32)


def _case_tensors(b, s, dtype, seed):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((b, L, K, D)).astype(np.float32)
    new = rng.standard_normal((b, s, K, D)).astype(np.float32)
    return (torch.from_numpy(cache).to(dtype), torch.from_numpy(new))


def _jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_write_in_place_equals_functional_and_reference(case, dtype):
    """A chunk's rows written in place equal ``_write_rows`` and the
    reference's drop-mode scatter (``repro/models/attention.py``
    ``gqa_chunk``: padding columns and idle rows index row L), bit for
    bit; the tensor written is the cache itself."""
    start, clen, s = CHUNK_CASES[case]
    b = len(start)
    cache, new = _case_tensors(b, s, dtype, seed=len(case))
    start_t = torch.tensor(start, dtype=torch.int32)
    clen_t = torch.tensor(clen, dtype=torch.int32)
    positions = start_t[:, None] + torch.arange(s, dtype=torch.int32)[None]
    valid = torch.arange(s)[None] < clen_t[:, None]
    want = tattn._write_rows(cache, new, positions, valid)
    idx = jnp.where(jnp.arange(s)[None, :] < jnp.asarray(clen)[:, None],
                    jnp.asarray(positions.numpy()), L)
    bidx = jnp.broadcast_to(jnp.arange(b)[:, None], (b, s))
    ref = _jax(cache).at[bidx, idx].set(
        _jax(new).astype(_jax(cache).dtype), mode="drop")
    got = cache.clone()
    out = tattn.write_rows_(got, new, positions, valid)
    assert out is got
    assert torch.equal(_bits(got), _bits(want))
    ref_t = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(dtype)
    assert torch.equal(_bits(got), _bits(ref_t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_write_in_place_equals_functional_and_reference(case, dtype):
    """A decode step's rows written in place (``_scatter_kv``) equal
    ``_write_rows``'s new cache and the reference's ``_scatter_kv``
    (``pos = max_len`` drops the write), bit for bit."""
    pos = torch.tensor(DECODE_CASES[case], dtype=torch.int32)
    cache, new = _case_tensors(pos.shape[0], 1, dtype, seed=len(case))
    want = tattn._write_rows(cache, new, pos[:, None],
                             torch.ones((pos.shape[0], 1), dtype=torch.bool))
    ref = jattn._scatter_kv(_jax(cache), _jax(new).astype(_jax(cache).dtype),
                            jnp.asarray(pos.numpy()))
    got = cache.clone()
    out = tattn._scatter_kv(got, new, pos)
    assert out is got
    assert torch.equal(_bits(got), _bits(want))
    ref_t = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(dtype)
    assert torch.equal(_bits(got), _bits(ref_t))


@pytest.mark.parametrize("mode", ["chunk", "decode"])
def test_gqa_writes_its_cache_in_place(mode):
    """``gqa_chunk``/``gqa_decode`` on reduced moonshot write their cache
    where it lies: the returned cache is the given tensors, holding the
    bytes ``_write_rows`` gives, and the output is the attention over
    that cache."""
    params = tm.params_from_numpy(tm.model()[3], "cpu")
    p = {k: v[0] for k, v in params["blocks"]["layer0"]["attn"].items()}
    gen = torch.Generator().manual_seed(2)
    b, s = (3, 8) if mode == "chunk" else (4, 1)
    x = torch.randn(b, s, CFG.d_model, generator=gen)
    cache = {n: torch.randn(b, L, K, D, generator=gen) for n in ("k", "v")}
    if mode == "chunk":
        kw = dict(positions=torch.tensor([[L - 8], [0], [4]]) +
                  torch.arange(s)[None], chunk_len=torch.tensor([8, 0, 3]))
        fn = tattn.gqa_chunk
    else:
        kw = dict(pos=torch.tensor([L - 1, L, 0, 6]))
        fn = tattn.gqa_decode
    mine = {n: t.clone() for n, t in cache.items()}
    got_o, got_kv = fn(p, x, mine, CFG, **kw)
    # the functional write of the same new rows
    q, k_new, v_new = tattn._project_qkv(p, x, CFG)
    if mode == "chunk":
        idx, valid = kw["positions"], (torch.arange(s)[None]
                                       < kw["chunk_len"][:, None])
    else:
        idx, valid = kw["pos"][:, None], torch.ones((b, 1), dtype=torch.bool)
    rope = idx if mode == "chunk" else kw["pos"][:, None]
    for n, new in (("k", tattn.apply_rope(k_new, rope, CFG.rope_theta)),
                   ("v", v_new)):
        assert got_kv[n] is mine[n]
        assert torch.equal(mine[n], tattn._write_rows(cache[n], new, idx,
                                                      valid))
    q = tattn.apply_rope(q, rope, CFG.rope_theta)
    if mode == "chunk":
        want_o = tattn._chunk_attention(q, mine["k"], mine["v"],
                                        CFG.head_dim ** -0.5, idx)
    else:
        want_o = tattn.scaled_attention(q, mine["k"], mine["v"],
                                        CFG.head_dim ** -0.5, causal=False,
                                        kv_valid=kw["pos"] + 1)
    assert torch.equal(got_o, tattn._out_proj(want_o, p["wo"]))


# --------------------------------------------------------------------------
# the engine's static-buffer step against the eager and reference engines
# --------------------------------------------------------------------------
def _held(tree):
    """``tree``'s containers copied, its tensors the same objects: what a
    captured graph holds (the tensors' addresses, not the engine's
    dicts)."""
    if isinstance(tree, dict):
        return {k: _held(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_held(v) for v in tree)
    return tree


def _emulated_record(body, state):
    """Stands in for a CUDA capture on the CPU: nothing runs now; a replay
    runs ``body`` on the tensors captured, whatever the engine holds by
    then."""
    held = _held(tuple(state))

    return lambda: body(*held)


def _emulate(eng):
    """Turn ``eng``'s static-buffer step into an emulated graphed one."""
    sg = eng._graphs
    sg.capture = True
    sg._record = _emulated_record
    return sg


ELASTIC_FAULTS = [(3, "fail", 2), (14, "rejoin", 2)]


def _arm_setup(arm, tmp_path):
    """(run_arm's arm name, n_req, extra factory, before, after_step) of
    one test arm; ``extra`` takes the engine arguments the port adds."""
    if arm in ("placement", "replicate"):
        return arm, tm.N_REQ, lambda port_kw: (
            lambda *a: ({}, dict(port_kw))), None, None
    if arm == "checkpoint":
        # a save and a load between two iterations of the placement arm:
        # the params come back as new tensors, the tables and m_state too
        def after_step(eng):
            if eng._it == 6:
                name = "port" if isinstance(eng, tm.TEngine) else "ref"
                d = str(tmp_path / f"load_{name}_{id(eng)}")
                eng.save_checkpoint(d, 6)
                eng.load_checkpoint(d)
        return "placement", tm.N_REQ, lambda port_kw: (
            lambda *a: ({}, dict(port_kw))), None, after_step
    assert arm == "kill_rejoin"
    cos, n_runs = {}, [0]

    def extra_for(port_kw):
        def extra(mj, mt, clock_j, clock_t, tel_j, tel_t):
            n_runs[0] += 1
            base = tmp_path / f"ck_{n_runs[0]}"
            cos["ref"] = JCo(mj, ckpt_dir=str(base / "ref"), clock=clock_j,
                             telemetry=tel_j)
            cos["port"] = ElasticCoordinator(
                mt, ckpt_dir=str(base / "port"), clock=clock_t,
                telemetry=tel_t)
            return ({"elastic": cos["ref"],
                     "fault_injector": JFI(ELASTIC_FAULTS)},
                    dict(port_kw, elastic=cos["port"],
                         fault_injector=FaultInjector(ELASTIC_FAULTS)))
        return extra

    def before(eng_j, eng_t):
        eng_j.save_checkpoint(cos["ref"].ckpt_dir, 0)
        eng_t.save_checkpoint(cos["port"].ckpt_dir, 0)
    return "replicate/L/async", 10, extra_for, before, None


def _port_equal(a, b):
    """Two port engines served the same stream: tokens, finish times,
    every IterStats field, m_state and the tables, bit for bit."""
    ta = {r.uid: (r.generated, r.finish_time) for r in a.scheduler.finished}
    tb = {r.uid: (r.generated, r.finish_time) for r in b.scheduler.finished}
    assert ta == tb
    assert [dataclasses.asdict(s) for s in a.stats] == \
        [dataclasses.asdict(s) for s in b.stats]
    assert torch.equal(a.m_state, b.m_state)
    assert a.migration_bytes_moved == b.migration_bytes_moved
    for x, y in zip(a._placement.device_tables(),
                    b._placement.device_tables()):
        assert np.array_equal(np.asarray(x), np.asarray(y))


ARMS = ("placement", "replicate", "kill_rejoin", "checkpoint")


@pytest.fixture(scope="module")
def arm_runs(tmp_path_factory):
    """Each arm served two ways: the port engine (the static-buffer step,
    uncaptured on the CPU) beside the reference's engine, and the port
    engine with emulated graphs; each run notes the table buffers'
    addresses after every step."""
    out = {}
    for arm in ARMS:
        tmp = tmp_path_factory.mktemp(arm.replace("/", "_"))
        name, n_req, extra_for, before, after = _arm_setup(arm, tmp)
        runs = {}
        for mode, port_kw, ref in (("static", {}, True),
                                   ("emulated", {}, False)):
            ptrs = []

            def after_step(eng, ptrs=ptrs, after=after):
                if after is not None:
                    after(eng)
                if isinstance(eng, tm.TEngine) and eng._place_bufs:
                    ptrs.append(tuple(t.data_ptr()
                                      for t in eng._place_bufs))

            def before_serve(eng_j, eng_t, mode=mode, before=before):
                if before is not None:
                    before(eng_j, eng_t)
                if mode == "emulated":
                    _emulate(eng_t)
            runs[mode] = (tm.run_arm(name, n_req=n_req,
                                     extra=extra_for(port_kw),
                                     before=before_serve,
                                     after_step=after_step, ref=ref), ptrs)
        out[arm] = runs
    return out


@pytest.mark.parametrize("arm", ARMS)
def test_static_step_matches_reference_engine(arm_runs, arm):
    """The static-buffer step, uncaptured on the CPU, gives the reference
    engine's tokens, IterStats, tables after every iteration, telemetry and
    m_state across the arm's event."""
    run, _ = arm_runs[arm]["static"]
    assert run.eng_t.step_mode == "eager (CPU)"
    tm.assert_streams_equal(run)


@pytest.mark.parametrize("arm", ARMS)
def test_emulated_graphs_match_uncaptured_engine(arm_runs, arm):
    """The step with emulated graphs (captured after its first call, then
    replayed over the tensors it was captured on) gives the uncaptured
    engine's stream bit for bit."""
    _port_equal(arm_runs[arm]["emulated"][0].eng_t,
                arm_runs[arm]["static"][0].eng_t)


@pytest.mark.parametrize("mode", ["static", "emulated"])
@pytest.mark.parametrize("arm", ARMS)
def test_table_buffers_keep_their_address(arm_runs, arm, mode):
    """Commits, weighted-split refreshes, elastic masks and a checkpoint
    load write the device tables into the same buffers."""
    run, ptrs = arm_runs[arm][mode]
    assert run.eng_t._placement.n_migrations > 0
    assert len(ptrs) > 0 and len(set(ptrs)) == 1


@pytest.mark.parametrize("arm", ARMS)
def test_emulated_graphs_replay_and_recapture_only_on_moved_weights(
        arm_runs, arm):
    """With emulated capture every key is captured once and replayed
    after; commits, refreshes and the elastic events write in place and
    drop nothing; a checkpoint load moves every weight, which drops the
    graphs, declares it and recaptures each key seen again."""
    eng = arm_runs[arm]["emulated"][0].eng_t
    sg = eng._graphs
    assert sg.captures["chunk"] >= 1 and sg.captures["decode"] >= 1
    assert sg.replays["decode"] > 0
    if arm == "checkpoint":
        assert len(sg.dropped) == 1 and "moved" in sg.dropped[0]
        assert sg.recaptures["decode"] >= 1
    else:
        assert sg.dropped == [] and sum(sg.recaptures.values()) == 0


# --------------------------------------------------------------------------
# bookkeeping with emulated graphs
# --------------------------------------------------------------------------
def _small_engine(graphs=None, **kw):
    from repro_torch.configs import ReaLBConfig
    from repro_torch.serving.engine import Engine
    _, cfg, _, pnum = tm.model()
    return Engine(cfg, tm.params_from_numpy(pnum, "cpu"),
                  ReaLBConfig(gate_gamma=8, md_init=0.0), max_slots=3,
                  max_len=48, prefill_budget=16, virtual_ep=4, device="cpu",
                  graphs=graphs, **kw)


def _requests(cfg, n=5, seed=3, base=0):
    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(seed)
    return [Request(uid=base + i, tokens=rng.integers(
        0, cfg.vocab_size, int(ln)).astype(np.int32),
        modality=rng.random(int(ln)) < 0.6, max_new_tokens=5)
        for i, ln in enumerate(rng.integers(3, 30, n))]


@pytest.mark.parametrize("graphs", [None, False, True])
def test_engine_step_mode_on_the_cpu(graphs):
    """The CPU runs the static-buffer step uncaptured, by default and with
    ``graphs=False``, and the sentinel's report says so; ``graphs=True``
    is refused (CUDA graphs need a card)."""
    sent = Sentinel()
    if graphs:
        with pytest.raises(ValueError, match="need a card"):
            _small_engine(graphs=graphs, sentinel=sent)
        return
    eng = _small_engine(graphs=graphs, sentinel=sent)
    assert eng.step_mode == "eager (CPU)"
    assert sent.report()["step"] == "eager (CPU)"
    assert eng._graphs.capture is False


def test_strict_sentinel_sees_no_new_capture_after_warm_up():
    """Two identical passes through an engine with emulated graphs under a
    strict sentinel: chunk and decode count captures by key (not input
    signatures), the second pass captures nothing new and replays every
    forward, and nothing pulls outside the sanctioned windows."""
    sent = Sentinel(strict=True)
    eng = _small_engine(sentinel=sent)
    sg = _emulate(eng)
    with sent:
        for r in _requests(eng.cfg):
            eng.submit(r)
        eng.run()
        warm = sent.mark_warm()
        caps = dict(sg.captures)
        for r in _requests(eng.cfg, base=10):
            eng.submit(r)
        n_before = len(eng.stats)
        eng.run()
    assert warm["chunk"] == caps["chunk"] >= 2
    assert warm["decode"] == caps["decode"] == 1
    assert sg.captures == caps
    assert sent.post_warm_recompiles() == {}
    assert sent.violations == [] and sent.ok
    assert sent.sanctioned_pulls.get("capture", 0) == sum(caps.values())
    assert sum(sg.replays.values()) >= len(eng.stats) - n_before


def test_static_step_keeps_state_at_its_address():
    """The static step writes m_state and the cache where they lie, and a
    chunk bucket or the decode reuses its input buffers."""
    eng = _small_engine()
    m_ptr = eng.m_state.data_ptr()
    k_ptr = eng.cache["blocks"]["layer0"]["k"].data_ptr()
    for r in _requests(eng.cfg):
        eng.submit(r)
    eng.run()
    assert eng.m_state.data_ptr() == m_ptr
    assert eng.cache["blocks"]["layer0"]["k"].data_ptr() == k_ptr
    keys = list(eng._graphs._inputs)
    assert len(keys) == len(set(keys))
    assert sum(k[0] == "decode" for k in keys) == 1


def test_failed_capture_raises_and_does_not_run_eager():
    """A capture that fails surfaces its error from the step."""
    eng = _small_engine()
    sg = eng._graphs
    sg.capture = True

    def broken(body, state):
        raise RuntimeError("capture failed")
    sg._record = broken
    for r in _requests(eng.cfg, n=1):
        eng.submit(r)
    with pytest.raises(RuntimeError, match="capture failed"):
        eng.step()


def test_failed_replay_raises():
    """A replay that fails surfaces its error from the step."""
    eng = _small_engine()
    sg = _emulate(eng)
    for r in _requests(eng.cfg, n=2):
        eng.submit(r)
    eng.run()

    def boom():
        raise RuntimeError("replay failed")
    for g in sg._graphs.values():
        g.replay = boom
    for r in _requests(eng.cfg, n=2, base=10):
        eng.submit(r)
    with pytest.raises(RuntimeError, match="replay failed"):
        eng.run()


def test_replaced_weight_drops_the_graphs_and_is_declared():
    """Rebinding one weight tensor (same values, a new address) between
    steps drops every graph, declares the drop to the sentinel, and the
    key is captured again; a write in place drops nothing."""
    sent = Sentinel()
    eng = _small_engine(sentinel=sent)
    sg = _emulate(eng)
    for base in (0, 10):
        for r in _requests(eng.cfg, n=3, base=base):
            eng.submit(r)
        eng.run()
        eng.params["final_norm"].add_(0)           # in place: kept
    assert sg.dropped == [] and sum(sg.replays.values()) > 0
    eng.params["final_norm"] = eng.params["final_norm"].clone()
    for r in _requests(eng.cfg, n=3, base=20):       # a new address
        eng.submit(r)
    eng.run()
    assert len(sg.dropped) == 1 and "1 of the" in sg.dropped[0]
    assert sum(sg.recaptures.values()) >= 1
    assert any("CUDA graphs dropped" in r for r in sent.rebuilds)
    assert sent.recaptures == {k: v for k, v in sg.recaptures.items() if v}


def test_replay_adds_the_launches_its_capture_recorded():
    """A capture takes back the counts its kernel wrappers added (it
    launches nothing); each replay adds the captured launches."""
    ops.reset_launch_counts()
    sg = tgraphs.StepGraphs("cpu", capture=True)

    def body(x):
        ops.add_launch_counts({"quantize_fp4": 3, "grouped_ffn": 1})
        return x + 1

    def record(body, state):
        out = body(*state)                     # the python runs, once
        return lambda: out                     # a replay runs none
    sg._record = record
    x = torch.zeros(2)
    sg.run("decode", "k", body, (x,))          # eager first call + capture
    assert ops.launch_counts()["quantize_fp4"] == 3
    assert sg._graphs[("k", ())].launches == {"quantize_fp4": 3,
                                              "grouped_ffn": 1}
    sg.run("decode", "k", body, (x,))
    sg.run("decode", "k", body, (x,))
    assert ops.launch_counts() == dict(ops.launch_counts(),
                                       quantize_fp4=9, grouped_ffn=3)
    assert sg.replays["decode"] == 2
    ops.reset_launch_counts()


def test_fingerprint_tracks_addresses_shapes_and_strides():
    a = torch.zeros(4, 6)
    tree = {"w": a, "t": (a[:2], None)}
    fp = tgraphs.fingerprint(tree)
    assert fp == tgraphs.fingerprint({"t": (a[:2], None), "w": a})
    assert fp != tgraphs.fingerprint({"w": a.clone(), "t": (a[:2], None)})
    assert fp != tgraphs.fingerprint({"w": a.t(), "t": (a[:2], None)})


def test_record_captures_into_the_pool_and_replays_its_outputs(monkeypatch):
    """``_record`` (CUDA's graph API faked: the CPU has none) captures the
    step thread-locally into the shared pool on the capture stream and
    returns a replay that launches the graph and returns the outputs the
    capture made; a key's replays return those same tensors."""
    import contextlib
    events = []

    class FakeGraph:
        def replay(self):
            events.append("replay")

    @contextlib.contextmanager
    def fake_capture(graph, pool=None, stream=None, capture_error_mode=None):
        events.append(("capture", pool, stream, capture_error_mode))
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 7))
    sg = tgraphs.StepGraphs("cpu", capture=True)
    monkeypatch.setattr(sg, "_side", lambda: "side")
    x = torch.zeros(3)
    first = sg.run("decode", "k", lambda t: t + 1, (x,))
    assert events == [("capture", (0, 7), "side", "thread_local")]
    again = sg.run("decode", "k", lambda t: t + 1, (x,))
    assert sg.run("decode", "k", lambda t: t + 1, (x,)) is again
    assert events[1:] == ["replay", "replay"]
    assert torch.equal(first, again) and first is not again
    assert sg.pool == (0, 7) and sg.replays["decode"] == 2


# --------------------------------------------------------------------------
# a forward's seconds, and the working launches counted on the device
# --------------------------------------------------------------------------
class _Clock:
    """A clock that only the test moves."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _WaitingSentinel(Sentinel):
    """Each sanctioned pull waits one second on ``clock``: the device
    finishing the forward behind a host that returned once it was
    enqueued."""

    def __init__(self, clock):
        super().__init__()
        self._clock = clock

    def sanctioned(self, label):
        if label in ("sample", "telemetry"):
            self._clock.t += 1.0
        return super().sanctioned(label)


def _timed_run(mode):
    """The small engine's stream with each sanctioned pull waiting one
    second: (its ``forward.*`` spans, its profiler, the engine)."""
    from repro_torch.obs import FlopByteLedger, Profiler, Tracer
    clock = _Clock()
    tracer = Tracer(clock=clock)
    eng = _small_engine(sentinel=_WaitingSentinel(clock), tracer=tracer,
                        clock=clock)
    eng.profiler = Profiler(FlopByteLedger(eng.cfg, ep=4))
    if mode == "emulated":
        _emulate(eng)
    for r in _requests(eng.cfg):
        eng.submit(r)
    eng.run()
    return ([e for e in tracer._events if e[1].startswith("forward.")],
            eng.profiler, eng)


@pytest.mark.parametrize("mode", ["uncaptured", "emulated"])
def test_forward_seconds_run_to_the_outputs_on_the_host(mode):
    """A forward's seconds (the profiler's, the cost gate's calibration)
    and its ``forward.*`` span run from its start to its statistics on the
    host, so a forward that returns once enqueued, as a graph's replay
    does, is charged the wait for its device work; graphed and uncaptured
    engines attribute the same seconds to the same phases."""
    fwd, prof, eng = _timed_run(mode)
    assert len(fwd) == len(eng.stats) == prof.n_iters > 0
    # the stats pull waited; a decode (and a chunk that completes a
    # prompt) pulled its tokens first and waited twice
    assert {e[4] for e in fwd} == {1.0, 2.0}
    assert all(e[4] == 2.0 for e in fwd if e[1] == "forward.decode")
    assert prof.fwd_s_total == sum(e[4] for e in fwd)
    if mode == "emulated":
        assert sum(eng._graphs.replays.values()) > 0
        _, want, _ = _timed_run("uncaptured")
        assert prof.phase_seconds() == want.phase_seconds()
        assert prof.time_scale() == want.time_scale()


def test_working_launches_are_counted_on_the_device_while_tracking():
    """A wrapper's working flag is added to the device counter only while
    tracking (the flag is not even made otherwise); tracking again zeroes
    the counter in place, so a graph captured over it keeps counting."""
    from repro_torch.kernels import working
    made = []

    def flag(v):
        def make():
            made.append(v)
            return torch.tensor(v)
        return make
    working.track(None)
    working.note("grouped_ffn", flag(True))
    assert made == [] and working.counts() == {}
    try:
        working.track("cpu")
        ptr = working._counter.data_ptr()
        working.note("grouped_ffn", flag(True))
        working.note("grouped_ffn", flag(False))
        working.note("quantize_fp4", flag([1]))
        working.note("global_scale_fp4", lambda: 1)
        assert working.counts() == {"quantize_fp4": 1,
                                    "global_scale_fp4": 1,
                                    "grouped_fp4_ffn": 0, "grouped_ffn": 1}
        working.track("cpu")
        assert working._counter.data_ptr() == ptr
        assert set(working.counts().values()) == {0}
    finally:
        working.track(None)

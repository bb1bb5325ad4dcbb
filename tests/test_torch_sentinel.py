"""The port's runtime sentinel: the host-pull guard on ``torch.Tensor``
(hot and sanctioned windows, strict mode, the patches coming off), the
input-signature counter of registered entries, the null object, and the
serving engine's invariants — a hot loop with tracer, profiler, audit and
sentinel all on pulls only through its sanctioned windows, and a second
pass after a warm-up that crossed a replan, a kill and a rejoin presents
no new input signature (mirrors tests/test_sentinel.py)."""
import numpy as np
import pytest
import torch

import _torch_managers as tm
from _torch_managers import one_torch_thread  # noqa: F401
from repro_torch.analysis import NULL_SENTINEL, Sentinel
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import quantize_fp4 as qk
from repro_torch.obs import FlopByteLedger, Profiler, ReplanAudit, Tracer
from repro_torch.replication import ReplicaManager, expand_moe_params
from repro_torch.runtime.fault_tolerance import FaultInjector
from repro_torch.serving.elastic import ElasticCoordinator
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

# prompt lengths whose chunks fill more than one prefill bucket
LENS = (5, 12, 20, 9, 16, 3, 14, 7)
PULLS = {
    "float": lambda t: float(t),
    "int": lambda t: int(t),
    "bool": lambda t: bool(t),
    "index": lambda t: [0, 1][t],
    "item": lambda t: t.item(),
    "tolist": lambda t: t.tolist(),
    "numpy": lambda t: t.numpy(),
    "asarray": lambda t: np.asarray(t),
}


# --------------------------------------------------------------------------
# host-pull guard
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pull", list(PULLS))
def test_hot_window_catches_each_host_pull(pull):
    with Sentinel() as s:
        x = torch.ones((), dtype=torch.int64)
        with s.hot("iter"):
            PULLS[pull](x)                 # unsanctioned device->host pull
    assert len(s.violations) >= 1
    v = s.violations[0]
    assert v.kind == "host_sync" and v.context == "iter"
    assert "test_torch_sentinel" in v.where
    assert not s.ok


def test_sanctioned_window_allows_pulls():
    with Sentinel() as s:
        x = torch.ones(())
        with s.hot("iter"):
            with s.sanctioned("telemetry"):
                float(x)
                int(torch.ones((), dtype=torch.int32))
                x.tolist()
    assert s.violations == []
    assert s.sanctioned_pulls == {"telemetry": 1}
    assert s.ok


def test_outside_hot_window_unguarded():
    with Sentinel() as s:
        float(torch.ones(()))              # between iterations: fine
    assert s.violations == []


def test_cpu_moves_of_cpu_tensors_are_not_pulls():
    """``.cpu()`` / ``.to("cpu")`` read the device only from a card."""
    with Sentinel() as s:
        x = torch.ones(3)
        with s.hot("iter"):
            x.cpu()
            x.to("cpu")
            x.to(torch.float64)
            x.to(device=torch.device("cpu"))
    assert s.violations == []


def test_plain_kernel_reads_of_cpu_inputs_pass():
    """A kernel's plain version reads its CPU predicate on the host, as
    the CPU stand-in of a kernel that reads it on the card."""
    w = torch.randn(2, 8, 32)
    with Sentinel(strict=True) as s:
        with s.hot("iter"):
            gs = qk.global_scale_plain(w, torch.ones((), dtype=torch.int32))
            qk.quantize_fp4_plain(w, gs, pred=torch.zeros((),
                                                          dtype=torch.int32))
    assert s.violations == []


def test_strict_raises_with_site():
    with Sentinel(strict=True) as s:
        with pytest.raises(RuntimeError, match="unsanctioned"):
            with s.hot("decode"):
                bool(torch.ones((), dtype=torch.bool))
    assert len(s.violations) == 1
    assert s.violations[0].context == "decode"


def test_guard_uninstalls_on_exit():
    names = ("item", "tolist", "numpy", "__bool__", "__int__", "__float__",
             "__index__", "cpu", "to")
    s = Sentinel()
    with s:
        with s.hot("iter"):
            assert all(n in torch.Tensor.__dict__ for n in names)
        assert all(n in torch.Tensor.__dict__ for n in names)
    assert not any(n in torch.Tensor.__dict__ for n in names)
    # a hot window of an unarmed sentinel installs and removes them too
    with s.hot("iter"):
        assert "item" in torch.Tensor.__dict__
    assert "item" not in torch.Tensor.__dict__
    float(torch.ones(()))
    assert len(s.violations) == 0


def test_device_compute_unaffected_inside_hot():
    with Sentinel() as s:
        x = torch.arange(8.0)
        with s.hot("iter"):
            y = torch.sum(x * 2)           # stays on the device: no pull
            z = x[x > 3]                   # indexing by a mask: no pull
    assert s.violations == []
    assert float(y) == 56.0 and z.numel() == 4


# --------------------------------------------------------------------------
# input-signature accounting
# --------------------------------------------------------------------------
def test_signature_counter_flags_new_shapes():
    s = Sentinel()
    f = s.register_entry("f", lambda x, cfg=None: x + 1)
    f(torch.ones(4))
    assert s.mark_warm() == {"f": 1}
    f(torch.zeros(4))                      # same signature
    assert s.post_warm_recompiles() == {}
    assert s.ok
    f(torch.ones(8))                       # new shape
    assert s.post_warm_recompiles() == {"f": 1}
    f(torch.ones(8, dtype=torch.float64))  # new dtype
    f(torch.ones(8), cfg=("static", 2))    # new static argument
    assert s.post_warm_recompiles() == {"f": 3}
    assert not s.ok


def test_register_entry_cumulative_across_generations():
    s = Sentinel()
    f1 = s.register_entry("f", lambda x: x + 1)
    f1(torch.ones(4))
    f2 = s.register_entry("f", lambda x: x + 2)  # an engine rebuild
    s.note_rebuild("capacity resize")
    f2(torch.ones(5))
    assert s.compile_counts() == {"f": 2}
    assert s.rebuilds == ["capacity resize"]


def test_null_sentinel_is_free_and_reentrant():
    assert not NULL_SENTINEL.enabled
    fn = lambda x: x  # noqa: E731
    assert NULL_SENTINEL.register_entry("f", fn) is fn
    with NULL_SENTINEL.hot("iter"):
        with NULL_SENTINEL.hot("iter"):
            with NULL_SENTINEL.sanctioned("x"):
                float(torch.ones(()))
    NULL_SENTINEL.note_rebuild("r")
    assert NULL_SENTINEL.ok
    assert NULL_SENTINEL.report()["ok"] is True


def test_report_shape():
    with Sentinel() as s:
        with s.hot("iter"):
            float(torch.ones(()))
    rep = s.report()
    assert set(rep) == {"ok", "violations", "sanctioned_pulls",
                        "compile_counts", "warm_counts",
                        "post_warm_recompiles", "rebuilds", "step",
                        "recaptures"}
    assert rep["ok"] is False and len(rep["violations"]) == 1


# --------------------------------------------------------------------------
# engine end-to-end: the serving invariants
# --------------------------------------------------------------------------
def _reqs(cfg, n=6, p_len=12, new=4, seed=0, lens=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if lens is not None:
            p_len = lens[i % len(lens)]
        toks = rng.integers(0, cfg.vocab_size, p_len).astype(np.int32)
        out.append(Request(uid=i, tokens=toks,
                           modality=np.full(p_len, bool(i % 2)),
                           max_new_tokens=new, arrival_time=0.0))
    return out


def _model():
    _, cfg, _, pnum = tm.model()
    return cfg, pnum


def test_engine_hot_loop_sync_free_with_obs_enabled():
    """With tracer, profiler, audit and a strict sentinel on, every host
    pull inside an iteration goes through a sanctioned window."""
    cfg, pnum = _model()
    mgr = ReplicaManager(cfg, tm.TRCfg(replan_every=4, warmup_iters=2,
                                       min_gain=0.0, per_layer=True), 4)
    mgr.audit = ReplanAudit()
    sent = Sentinel(strict=True)
    with sent:
        eng = Engine(cfg, expand_moe_params(params_from_numpy(pnum, "cpu"),
                                            mgr.rsets),
                     tm.TCfg(gate_gamma=4), max_slots=3, max_len=32,
                     placement=mgr, tracer=Tracer(clock=lambda: 0.0),
                     profiler=Profiler(FlopByteLedger(cfg, ep=4)),
                     sentinel=sent, device="cpu")
        for r in _reqs(cfg):
            eng.submit(r)
        done = eng.run()
    assert len(done) == 6
    assert sent.violations == [], [v.where for v in sent.violations]
    assert sent.sanctioned_pulls.get("telemetry", 0) > 0
    assert sent.sanctioned_pulls.get("sample", 0) > 0
    assert len(mgr.audit) > 0 and mgr.audit.query(verdict="staged")
    assert eng.profiler.n_iters == len(eng.stats)


def test_engine_no_new_signatures_across_replan_kill_rejoin(tmp_path):
    """A warm-up pass covers replans, table commits, a kill/rejoin cycle,
    async drains and every chunked-prefill bucket; an identical second
    pass calls the forwards with no input signature it has not seen."""
    cfg, pnum = _model()
    mgr = ReplicaManager(cfg, tm.TRCfg(
        replan_every=4, warmup_iters=2, min_gain=0.0, per_layer=True,
        spare_per_rank=1, max_replicas=2), 4)
    co = ElasticCoordinator(mgr, ckpt_dir=str(tmp_path))
    fi = FaultInjector([(3, "fail", 2), (14, "rejoin", 2)])
    sent = Sentinel(strict=True)
    with sent:
        eng = Engine(cfg, expand_moe_params(params_from_numpy(pnum, "cpu"),
                                            mgr.rsets),
                     tm.TCfg(gate_gamma=4), max_slots=3, max_len=32,
                     prefill_budget=16, placement=mgr, migrate_async=True,
                     migrate_bytes_per_iter=1, elastic=co,
                     fault_injector=fi, sentinel=sent, device="cpu")
        for r in _reqs(cfg, n=8, new=6, lens=LENS):
            eng.submit(r)
        eng.save_checkpoint(str(tmp_path), 0)
        eng.run()
        eng.drain_migrations()
        assert fi.exhausted and co.events
        assert any(s.n_unroutable > 0 for s in eng.stats)
        warm = sent.mark_warm()
        assert set(warm) == {"prefill", "chunk", "decode"}
        assert warm["chunk"] > 1 and warm["decode"] >= 1
        for r in _reqs(cfg, n=8, new=6, lens=LENS):
            eng.submit(r)
        eng.run()
        eng.drain_migrations()
    assert sent.post_warm_recompiles() == {}, sent.compile_counts()
    assert sent.violations == [], [v.where for v in sent.violations]
    assert sent.ok

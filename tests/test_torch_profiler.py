"""The port's hot-loop profiler against the reference's: the FLOP/byte
ledger equals ``repro.obs.ledger`` exactly under the reference's TPU
constants and prices the H100 from its record; the profiler's attribution,
``time_scale`` and drift equal the reference's on the same inputs; every
``stop_stage`` prefix of the MoE layer matches the reference's prefix and
the full prefix is the layer bit for bit; an engine with the profiler
serves what one without serves, and wires its drift EWMA into an unwired
cost gate (mirrors tests/test_profiler.py)."""
import dataclasses
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_managers as tm
from _torch_managers import one_torch_thread  # noqa: F401
from repro.configs import ReaLBConfig as JCfg
from repro.core import ep_moe as jmoe
from repro.obs import FlopByteLedger as JLedger
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Profiler as JProfiler
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import hw
from repro_torch.configs.base import MIGRATION_BW_DEFAULT
from repro_torch.convert import params_from_numpy
from repro_torch.core import ep_moe as tmoe
from repro_torch.obs import (MOE_STAGES, NULL_PROFILER, PHASES,
                             FlopByteLedger, MetricsRegistry, Profiler,
                             time_moe_phases)
from repro_torch.obs.ledger import BYTES_BF16, BYTES_FP4
from test_torch_model import ATOL_REL, RTOL
from test_torch_moe import FP4, VEP, _setup

EP = 4
# the reference's TPU v5e constants (repro.configs.hw), only for parity:
# the port's own records are the H100's
TPU = hw.Hardware("TPU v5e (reference)", peak_bf16=197e12,
                  peak_fp4_gemm=394e12, peak_f32=0.0, hbm_bw=819e9)


def _stats(loads):
    """[L, 2, ep] moe_stats with the given [L, ep] routed loads."""
    loads = np.asarray(loads, np.float64)
    ms = np.zeros((loads.shape[0], 2, loads.shape[1]))
    ms[:, 0] = loads
    ms[:, 1] = loads * 0.5
    return ms


def _cfgs():
    cfg_j, cfg_t, _, _ = tm.model()
    return cfg_j, cfg_t


LEDGER_CASES = {
    "bf16": ([[6.0, 2.0, 1.0, 1.0], [2.5, 2.5, 2.5, 2.5]], 0.0, False),
    "fp4_hot_rank_fused": ([[6.0, 2.0, 1.0, 1.0]], 1.0, True),
    "fp4_unfused": ([[6.0, 2.0, 1.0, 1.0]], 1.0, False),
    "all_fp4": ([[6.0, 2.0, 1.0, 1.0], [0.0, 9.0, 3.0, 1.0]], 4.0, True),
    "groups_axis": ([[3.0, 1.0, 0.0, 2.0]], 2.0, False),
}


# --------------------------------------------------------------------------
# ledger
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(LEDGER_CASES))
def test_ledger_equals_reference_under_tpu_constants(case):
    loads, fp4, fused = LEDGER_CASES[case]
    cfg_j, cfg_t = _cfgs()
    ms = _stats(loads)
    if case == "groups_axis":                  # [L, 2, groups, ep]
        ms = np.stack([ms, ms], axis=2)
    lj = JLedger(cfg_j, ep=EP, fused=fused)
    lt = FlopByteLedger(cfg_t, ep=EP, fused=fused, hardware=TPU)
    for tokens, batch in ((10.0, 16.0), (0.0, 8.0), (513.0, 1024.0)):
        a = lj.account(ms, fp4, tokens, batch)
        b = lt.account(ms, fp4, tokens, batch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        c = lj.account(ms, fp4, tokens, batch, ici_bw=7e9)
        d = lt.account(ms, fp4, tokens, batch, ici_bw=7e9)
        assert dataclasses.asdict(c) == dataclasses.asdict(d)
    assert np.array_equal(lj.rank_loads(ms), lt.rank_loads(ms))
    assert lj.other_params == lt.other_params


def test_ledger_private_formulas_equal_reference():
    cfg_j, cfg_t = _cfgs()
    for fused in (False, True):
        lj = JLedger(cfg_j, ep=EP, fused=fused)
        lt = FlopByteLedger(cfg_t, ep=EP, fused=fused, hardware=TPU)
        for t in (0.0, 7.0, 513.0):
            for fp4 in (False, True):
                assert lj._expert_gemm_s(t, fp4) == lt._expert_gemm_s(t, fp4)
            assert lj._nongemm_s(t) == lt._nongemm_s(t)
            assert lj._dispatch_s(t, MIGRATION_BW_DEFAULT) == \
                lt._dispatch_s(t, MIGRATION_BW_DEFAULT)
        for disp in (0.0, 3e-6, 1e-3):
            assert lj._quantize_visible_s(disp) == \
                lt._quantize_visible_s(disp)
        assert lj._quantize_s() == lt._quantize_s()


def test_ledger_hand_counts_under_h100():
    """The reference's hand count, priced with the H100 SXM record: FP4
    expert GEMMs run at the bf16 rate (no FP4 tensor cores)."""
    _, cfg = _cfgs()
    led = FlopByteLedger(cfg, ep=EP, hardware=hw.H100_SXM)
    assert led.hw.peak_fp4_gemm == led.hw.peak_bf16 == 989e12
    loads = np.array([[6.0, 2.0, 1.0, 1.0], [2.5, 2.5, 2.5, 2.5]])
    tokens = 10.0
    it = led.account(_stats(loads), fp4_layers=1.0, tokens=tokens,
                     batch_tokens=16.0)
    d, dff, e, k = led.d, led.d_ff, led.n_experts, led.top_k
    gemm_per_tok = 2.0 * led.mult * d * dff
    w_slab = led.e_loc * led.mult * d * dff
    n_l = loads.shape[0]
    assert it.flops["route"] == pytest.approx(n_l * tokens * d * e * 2.0)
    assert it.flops["expert_gemm"] == pytest.approx(
        loads.sum() * gemm_per_tok)
    # the hottest rank of each layer (rank 0; ties pick the last index)
    # runs FP4
    assert it.flops_by_rate["int8"] == pytest.approx(
        (6.0 + 2.5) * gemm_per_tok)
    assert it.hbm_bytes["quantize_fp4"] == pytest.approx(
        n_l * w_slab * (BYTES_BF16 + BYTES_FP4))
    a2a = tokens * k / EP * (EP - 1) / EP * d * BYTES_BF16 * EP
    assert it.ici_bytes["dispatch"] == pytest.approx(n_l * a2a)
    assert it.model_flops == pytest.approx(
        2.0 * cfg.active_param_count() * tokens)
    other = 2.0 * led.other_params * tokens
    assert it.pred_s["other"] == pytest.approx(max(
        other / 989e12,
        (led.other_params * BYTES_BF16 + tokens * d * BYTES_BF16 * 8.0)
        / 3.35e12))
    # unfused (the default): an FP4 rank also pays the dequantized BF16
    # slab's round trip
    fp4_w = BYTES_FP4 + 2.0 * BYTES_BF16
    worst = max(
        max(6.0 * gemm_per_tok / 989e12,
            (w_slab * fp4_w + 6.0 * d * BYTES_BF16 * 4.0) / 3.35e12),
        max(2.0 * gemm_per_tok / 989e12,
            (w_slab * BYTES_BF16 + 2.0 * d * BYTES_BF16 * 4.0) / 3.35e12))
    row1 = max(max(2.5 * gemm_per_tok / 989e12,
                   (w_slab * w + 2.5 * d * BYTES_BF16 * 4.0) / 3.35e12)
               for w in (fp4_w, BYTES_BF16))
    assert it.pred_s["expert_gemm"] == pytest.approx(worst + row1)
    assert set(it.pred_s) == set(PHASES)
    json.dumps([it.flops, it.hbm_bytes, it.ici_bytes, it.pred_s])


def test_hardware_records_by_device_name():
    assert hw.for_device_name("NVIDIA H100 80GB HBM3") is hw.H100_SXM
    assert hw.for_device_name("NVIDIA H100 PCIe") is hw.H100_PCIE
    assert hw.for_device_name("NVIDIA H100 NVL") is hw.H100_NVL
    with pytest.raises(ValueError):
        hw.for_device_name("Some Other GPU")
    if not torch.cuda.is_available():
        assert hw.current() is hw.H100_SXM
    for rec in (hw.H100_SXM, hw.H100_PCIE, hw.H100_NVL):
        assert rec.peak_fp4_gemm == rec.peak_bf16


# --------------------------------------------------------------------------
# profiler accounting against the reference's
# --------------------------------------------------------------------------
def _feeds(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        loads = rng.integers(0, 12, (2, EP)).astype(np.float64)
        out.append(dict(moe_stats=_stats(loads), fp4_layers=float(i % 3),
                        tokens=float(loads.sum() / 2 + 1),
                        batch_tokens=16.0, fwd_s=1e-3 * (1 + i % 4),
                        phase="prefill" if i % 2 else "decode"))
    return out


def test_profiler_equals_reference_on_the_same_feeds():
    cfg_j, cfg_t = _cfgs()
    rj, rt = JRegistry(), MetricsRegistry()
    pj = JProfiler(JLedger(cfg_j, ep=EP), registry=rj)
    pt = Profiler(FlopByteLedger(cfg_t, ep=EP, hardware=TPU), registry=rt)
    for f in _feeds():
        a = pj.observe_iter(**f)
        b = pt.observe_iter(**f)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert pj.span_args() == pt.span_args()
    assert pj.summary() == pt.summary()
    assert pj.time_scale() == pt.time_scale()
    assert pj.drift() == pt.drift()
    assert rj.snapshot() == rt.snapshot()
    # exhaustive attribution: the phases partition the forward seconds
    assert sum(pt.phase_seconds().values()) == pytest.approx(pt.fwd_s_total)
    assert 0.0 < pt.roofline_fraction() <= 1.0


def test_profiler_measured_phase_override_rescales():
    _, cfg = _cfgs()
    prof = Profiler(FlopByteLedger(cfg, ep=EP))
    prof.observe_iter(moe_stats=_stats([[4.0, 2.0, 1.0, 1.0]]),
                      fp4_layers=0.0, tokens=8.0, batch_tokens=8.0,
                      fwd_s=0.01,
                      measured_phases={"route": 3.0, "dispatch": 1.0})
    ps = prof.phase_seconds()
    assert ps["route"] == pytest.approx(0.0075)
    assert ps["dispatch"] == pytest.approx(0.0025)
    assert sum(ps.values()) == pytest.approx(0.01)
    # MFU against the card's record
    assert prof.mfu() == pytest.approx(
        prof.model_flops_total / (0.01 * hw.current().peak_bf16))


def test_null_profiler_is_inert_singleton():
    assert NULL_PROFILER.enabled is False
    NULL_PROFILER.observe_iter(moe_stats=None, fwd_s=-1.0)
    assert NULL_PROFILER.time_scale() == 1.0
    assert NULL_PROFILER.mfu() == 0.0
    assert NULL_PROFILER.span_args() == {}


def test_profile_json_schema(tmp_path):
    _, cfg = _cfgs()
    prof = Profiler(FlopByteLedger(cfg, ep=EP))
    for f in _feeds(3):
        prof.observe_iter(**f)
    doc = prof.write(str(tmp_path / "p.json"), metadata={"arm": "t"})
    back = json.loads((tmp_path / "p.json").read_text())
    assert back == doc and doc["schema"] == "repro.profile.v1"
    assert sum(v["measured_s"] for v in doc["phases"].values()) == \
        pytest.approx(doc["totals"]["forward_s"])


# --------------------------------------------------------------------------
# instrumented prefixes
# --------------------------------------------------------------------------
def _leaves(out):
    """Flatten a prefix's boundary values (tensors, dicts, QTensors)."""
    if isinstance(out, dict):
        for k in sorted(out):
            yield from _leaves(out[k])
    elif isinstance(out, tuple):
        for v in out:
            yield from _leaves(v)
    else:
        yield out


def _as_np(a):
    """A boundary value as numpy (float8 scales widened to f32)."""
    if isinstance(a, torch.Tensor):
        if a.is_floating_point() and a.element_size() == 1:
            a = a.float()
        return a.numpy()
    a = jnp.asarray(a)
    if jnp.issubdtype(a.dtype, jnp.floating) and a.dtype.itemsize == 1:
        a = a.astype(jnp.float32)
    return np.asarray(a)


def _inputs(mode):
    cfg_j, cfg_t, p, x, mod, valid = _setup()
    if mode == "broadcast":            # decode: 12 rows of one token each
        x = x.reshape(-1, 1, x.shape[-1])[-12:]
        mod, valid = mod.reshape(-1, 1)[-12:], valid.reshape(-1, 1)[-12:]
    m = np.full((1, VEP), 0.0, np.float32)
    jargs = ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    targs = (params_from_numpy(p, "cpu"), torch.from_numpy(x))
    return (cfg_j, cfg_t, jargs, targs, m, mod, valid)


@pytest.mark.parametrize("mode", ["dispatch", "broadcast"])
@pytest.mark.parametrize("pol", ["fp4", "bf16"])
def test_stop_stage_prefixes_match_reference(mode, pol):
    """Each prefix's boundary values equal the reference's: integers and
    flags exactly, floats at the model-level tolerance; the last prefix
    is ``ep_moe_forward`` bit for bit."""
    cfg_j, cfg_t, jargs, targs, m, mod, valid = _inputs(mode)
    kw = FP4 if pol == "fp4" else dict(gate_gamma=10 ** 9)
    jr, tr = JCfg(**kw), TCfg(**kw)
    for stage in MOE_STAGES[mode][:-1]:
        fn = jax.jit(partial(jmoe.ep_moe_forward, cfg=cfg_j, rcfg=jr,
                             mode=mode, stop_stage=stage))
        out_j = fn(*jargs, m_state=jnp.asarray(m), modality=jnp.asarray(mod),
                   valid=jnp.asarray(valid))
        out_t = tmoe.ep_moe_forward(
            *targs, cfg_t, tr, torch.from_numpy(m), torch.from_numpy(mod),
            mode=mode, valid=torch.from_numpy(valid), stop_stage=stage)
        lj, lt = list(_leaves(out_j)), list(_leaves(out_t))
        assert len(lj) == len(lt), stage
        for i, (a, b) in enumerate(zip(lj, lt)):
            a, b = _as_np(a), _as_np(b)
            if pol == "bf16" and stage == "quantize_fp4" and b.ndim == 0 \
                    and b.dtype == np.float32:
                # the global scale of a quantization that did not run: the
                # reference's placeholder is 1, the port's plain version 0
                continue
            assert a.shape == b.shape, (stage, i, a.shape, b.shape)
            if b.dtype.kind in "biu" or a.dtype.kind in "biu":
                assert np.array_equal(a.astype(np.int64),
                                      b.astype(np.int64)), (stage, i)
            else:
                np.testing.assert_allclose(
                    b, a, rtol=RTOL, err_msg=f"{stage} {i}",
                    atol=ATOL_REL * max(float(np.abs(a).max()), 1e-30))
    full = tmoe.ep_moe_forward(
        *targs, cfg_t, tr, torch.from_numpy(m), torch.from_numpy(mod),
        mode=mode, valid=torch.from_numpy(valid), stop_stage=None)
    ref = tmoe.ep_moe_forward(
        *targs, cfg_t, tr, torch.from_numpy(m), torch.from_numpy(mod),
        mode=mode, valid=torch.from_numpy(valid))
    assert torch.equal(full[0], ref[0]) and torch.equal(full[1], ref[1])


@pytest.mark.parametrize("mode", ["dispatch", "broadcast"])
@pytest.mark.parametrize("overlap", [True, False])
def test_time_moe_phases_full_output_is_the_layer(mode, overlap):
    _, cfg_t, _, targs, m, mod, valid = _inputs(mode)
    rcfg = TCfg(**FP4, overlap=overlap)
    args = (*targs, cfg_t, rcfg, torch.from_numpy(m))
    seconds, (y, m2, aux) = time_moe_phases(
        *args, mode=mode, modality=torch.from_numpy(mod),
        valid=torch.from_numpy(valid), repeats=1, warmup=1)
    assert set(seconds) == set(MOE_STAGES[mode])
    assert all(v >= 0.0 for v in seconds.values())
    y_r, m_r, aux_r = tmoe.ep_moe_forward(
        *args, torch.from_numpy(mod), mode=mode,
        valid=torch.from_numpy(valid))
    assert y.numpy().tobytes() == y_r.numpy().tobytes()
    assert m2.numpy().tobytes() == m_r.numpy().tobytes()
    assert set(aux) == set(aux_r)
    for k in aux:
        assert torch.equal(aux[k], aux_r[k]), k
    assert float(aux["fp4_ranks"]) > 0          # the gate really opened


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------
class _StubGate:
    """A replan cost gate that accepts every plan and records the
    time scale it was calibrated with."""

    def __init__(self, time_scale=None):
        self.time_scale = time_scale

    def accept(self, old, new, moved):
        return True

    def accept_layers(self, old, new, moved):
        return True


def _served_arm(profiled):
    """The ``replicate/L/async`` virtual-time arm of
    tests/_torch_managers.py with (or without) a profiler on each
    engine."""
    cfg_j, cfg_t = _cfgs()
    prof = None
    if profiled:
        prof = (JProfiler(JLedger(cfg_j, ep=EP)),
                Profiler(FlopByteLedger(cfg_t, ep=EP, hardware=TPU)))

    def extra(*_):
        return ({"profiler": prof[0]}, {"profiler": prof[1]}) if prof \
            else ({}, {})
    return tm.run_arm("replicate/L/async", extra=extra), prof


def test_engine_with_profiler_serves_as_without():
    """Tokens, every IterStats field and the tables after every iteration
    are the unprofiled engine's; the port's profiler equals the
    reference's on the same virtual-time run (TPU constants plugged in)."""
    base, _ = _served_arm(False)
    run, (pj, pt) = _served_arm(True)
    tm.assert_streams_equal(run)
    assert {u: r.generated for u, r in run.done_t.items()} == \
        {u: r.generated for u, r in base.done_t.items()}
    assert [dataclasses.asdict(s) for s in run.eng_t.stats] == \
        [dataclasses.asdict(s) for s in base.eng_t.stats]
    assert len(run.tables_t) == len(base.tables_t)
    for a, b in zip(run.tables_t, base.tables_t):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert pt.n_iters == len(run.eng_t.stats) > 0
    assert pj.summary() == pt.summary()
    assert sum(pt.phase_seconds().values()) == pytest.approx(pt.fwd_s_total)
    assert pt.fwd_s_total > 0 and pt.mfu() > 0


def test_engine_wires_profiler_time_scale_into_cost_gate():
    cfg_j, cfg_t, _, pnum = tm.model()
    pt = params_from_numpy(pnum, "cpu")
    prof = Profiler(FlopByteLedger(cfg_t, ep=EP))

    def engine(gate, profiler):
        mgr = tm.TPM(cfg_t, tm.TPCfg(replan_every=3, warmup_iters=1,
                                    min_gain=0.0), EP, cost_gate=gate)
        return tm.TEngine(cfg_t, pt, TCfg(), max_slots=2, max_len=32,
                          placement=mgr, profiler=profiler, device="cpu")

    gate = _StubGate()
    engine(gate, prof)
    assert gate.time_scale == prof.time_scale      # the bound EWMA method
    assert gate.time_scale() == 1.0                # no observations yet
    preset = _StubGate(time_scale=1.5)
    engine(preset, prof)
    assert preset.time_scale == 1.5
    untouched = _StubGate()
    engine(untouched, None)
    assert untouched.time_scale is None

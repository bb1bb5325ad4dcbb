"""The dispatch audit (``analysis.dispatch_audit``), the counterpart of the
reference's jaxpr audit: reduced bf16 forwards of every architecture are
clean on the CPU and on ``meta``, and an injected host read, an f64
value, a data-shaped op and an unlisted widening on the MoE path are each
flagged.  The allowlist words count only in the functions below a MoE
phase, and the one widening of the reference's algorithm that its rule
flags (the BF16 decode experts' f32 activation) is held at its count."""
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.analysis.dispatch_audit import (DEFAULT_WIDEN_ALLOWLIST,
                                                 KNOWN_WIDENINGS,
                                                 DispatchAudit, audit)
from repro_torch.configs import (ARCH_IDS, ReaLBConfig, ShapeConfig,
                                 get_config, reduced)
from repro_torch.core import ep_moe
from repro_torch.launch import steps

from test_torch_op_analysis import concrete_inputs

ARCH = "moonshot-v1-16b-a3b"


def _step(arch, kind, device, seq=32, b=2):
    cfg = reduced(get_config(arch), param_dtype="bfloat16")
    shape = ShapeConfig(kind, seq, b, kind)
    step, names = steps.build_step(cfg, shape, ReaLBConfig())
    inputs = concrete_inputs(cfg, shape) if device == "cpu" \
        else steps.input_specs(cfg, shape)
    return step, [inputs[n] for n in names], inputs


def expected_known(cfg, kind, m_state):
    """``_swiglu``'s widenings in a forward: one a slab of BF16 decode
    products, ``m_state``'s policy ranks a MoE layer without a mesh."""
    n_moe = sum(1 for f in cfg.ffn_kinds() if f == "moe")
    return n_moe * m_state.shape[-1] if kind == "decode" else 0


def test_allowlist_keeps_the_reference_words():
    from repro.analysis.jaxpr_audit import \
        DEFAULT_WIDEN_ALLOWLIST as REFERENCE
    assert tuple(REFERENCE) == DEFAULT_WIDEN_ALLOWLIST
    assert KNOWN_WIDENINGS == ("_swiglu",)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_forwards_are_clean(arch, kind, device):
    step, args, inputs = _step(arch, kind, device)
    rep = audit(step, *args)
    assert rep.ok, [v.format() for v in rep.violations]
    assert rep.n_ops > 100
    cfg = reduced(get_config(arch))
    assert len(rep.known) == expected_known(cfg, kind, inputs["m_state"])
    assert all(k["where"].endswith("/_moe_broadcast/_swiglu")
               for k in rep.known)
    # bf16 stacks widen for their norms, softmax and RoPE, all allowed
    assert rep.widenings
    assert rep.f64_allowed > 0 or get_config(arch).layer_pattern == "ssm"


def _flagged(monkeypatch, name, inject, kind="decode"):
    step, args, _ = _step(ARCH, kind, "cpu")
    orig = getattr(ep_moe, name)

    def patched(*a, **kw):
        out = orig(*a, **kw)
        inject(out)
        return out

    monkeypatch.setattr(ep_moe, name, patched)
    rep = audit(step, *args)
    return rep.violations


def test_injected_item_is_flagged(monkeypatch):
    bad = _flagged(monkeypatch, "_use_fp4", lambda f: f.item())
    assert bad and {v.kind for v in bad} == {"host_sync"}
    assert all("_moe_broadcast" in v.where for v in bad)
    assert "_local_scalar_dense" in bad[0].op


def test_f64_is_flagged(monkeypatch):
    bad = _flagged(monkeypatch, "_use_fp4",
                   lambda f: f.to(torch.float64) * 2.0)
    assert {v.kind for v in bad} >= {"f64"}


def test_data_shaped_op_is_flagged(monkeypatch):
    bad = _flagged(monkeypatch, "_use_fp4", lambda f: torch.nonzero(f))
    assert {v.kind for v in bad} == {"data_shape"}


def test_unlisted_widening_is_flagged(monkeypatch):
    """A bf16 value widened to f32 in the dispatch phase, in a function
    whose name is on no allowlist (``_use_fp4``)."""
    def widen(f):
        torch.ones(4, dtype=torch.bfloat16).to(torch.float32)
    bad = _flagged(monkeypatch, "_use_fp4", widen, kind="prefill")
    assert bad and {v.kind for v in bad} == {"widening"}
    assert all("_moe_dispatch" in v.where for v in bad)


def test_widening_off_the_moe_path_and_dequant_are_allowed():
    with DispatchAudit() as a:
        torch.ones(4, dtype=torch.bfloat16).to(torch.float32)
    assert a.report().ok and len(a.report().widenings) == 1


def test_kernel_entries_are_not_audited():
    """The plain versions read their CPU inputs on the host (``.tolist()``
    of the counts); on the card the entry is one launch."""
    from repro_torch.kernels import ops
    xs = torch.randn(8, 32)
    gs = torch.tensor([5, 3], dtype=torch.int32)
    w = {k: torch.randn(2, *s) for k, s in (("w_gate", (32, 64)),
                                            ("w_up", (32, 64)),
                                            ("w_down", (64, 32)))}
    rep = audit(ops.grouped_ffn, xs, gs, w)
    assert rep.ok and rep.n_ops == 0
    np.testing.assert_array_equal(ops.grouped_ffn(xs, gs, w).shape, (8, 32))


_FIXTURE = """
import torch

def widen():
    torch.ones(4, dtype=torch.bfloat16).to(torch.float32)

def _swiglu():
    torch.ones(4, dtype=torch.bfloat16).to(torch.float32)

def _route_part():
    widen()

def _moe_dispatch(inner):
    inner()

def _norm_caller(inner):
    _moe_dispatch(inner)
"""


@pytest.mark.parametrize("call,flagged,known", [
    # the phase's own helper: on no allowlist
    (lambda ns: ns["_moe_dispatch"](ns["widen"]), True, 0),
    # a word in a function below the phase allows it
    (lambda ns: ns["_moe_dispatch"](ns["_route_part"]), False, 0),
    # a word above the phase does not
    (lambda ns: ns["_norm_caller"](ns["widen"]), True, 0),
    # the known widening, listed and not flagged, on the path only
    (lambda ns: ns["_moe_dispatch"](ns["_swiglu"]), False, 1),
    (lambda ns: ns["_swiglu"](), False, 0),
])
def test_allowlist_matches_below_the_phase(call, flagged, known):
    """Functions of a module compiled as a file of the port: the
    allowlist words and the known widenings are matched in the frames
    below the MoE phase, by whole function name for the phase and the
    known widening."""
    ns = {}
    exec(compile(textwrap.dedent(_FIXTURE), "repro_torch/_fixture.py",
                 "exec"), ns)
    with DispatchAudit() as a:
        call(ns)
    rep = a.report()
    assert len(rep.widenings) == 1
    assert (not rep.ok) == flagged
    assert len(rep.known) == known

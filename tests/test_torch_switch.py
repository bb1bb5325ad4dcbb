"""ReaLB's BF16/FP4 switch kept on the device, on the CPU: the predicated
plain versions (flag off gives exactly 0), the BF16 grouped FFN against the
reference's ``_grouped_ffn`` with counts masked by the flag and a pad slot
without weights, and the MoE layer with its decision forced on and off,
against the reference forced the same way.  Inputs are numpy-seeded."""
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
from repro_torch.convert import params_from_numpy, tensor_from_numpy, to_numpy
from repro_torch.core import ep_moe as tmoe
from repro_torch.kernels import ops as tops

# (m, d, f, gs): the reference's GROUPED_CASES (tests/test_kernels.py); the
# last slot is taken as the pad slot (zero rows, no weights)
GROUPED_CASES = [
    (24, 64, 64, [3, 0, 5, 0, 0, 9, 7, 0, 0]),
    (16, 64, 96, [0, 16, 0, 0, 0]),
    (40, 128, 64, [40, 0, 0]),
    (37, 64, 64, [10, 0, 12, 15]),
    (32, 64, 64, [6, 10, 0, 16]),
    (8, 32, 32, [1, 2, 0, 5]),
]
FP4 = dict(gate_gamma=8, md_init=0.0, adaptive=False)   # the policy fires
BF16 = dict(gate_gamma=10 ** 9)                          # the gate is closed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flag(on: bool) -> torch.Tensor:
    return torch.tensor(on)


def _stack(seed, g, rows, cols):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g, rows, cols)) * 0.3
            / np.sqrt(max(rows / 64, 1.0))).astype(np.float32)


def test_quantizer_predicated_plain():
    """Flag on: the unpredicated result bitwise; off: zeros."""
    w = torch.from_numpy(_stack(0, 3, 48, 64)).transpose(-1, -2)
    q = tops.quantize_experts_fp4(w)
    on = tops.quantize_experts_fp4(w, pred=_flag(True))
    off = tops.quantize_experts_fp4(w, pred=_flag(False))
    for a, b, c in zip(q, on, off):
        assert torch.equal(a, b)
        assert c.shape == a.shape and c.dtype == a.dtype
        assert torch.all(c == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_plain_with_zero_counts_is_zero(dtype):
    """Both expert FFNs with the counts the off flag leaves are exactly 0."""
    m, d, f = 24, 64, 64
    gs = torch.tensor([5, 0, 9, 10], dtype=torch.int32) * 0
    xs = torch.randn(m, d, generator=torch.Generator().manual_seed(0)) \
        .to(dtype)
    w = {"w_gate": torch.from_numpy(_stack(1, 4, d, f)).to(dtype),
         "w_up": torch.from_numpy(_stack(2, 4, d, f)).to(dtype),
         "w_down": torch.from_numpy(_stack(3, 4, f, d)).to(dtype)}
    wq = {n: tops.quantize_experts_fp4(v.transpose(-1, -2))
          for n, v in w.items()}
    for y in (tops.grouped_ffn(xs, gs, w), tops.grouped_fp4_ffn(xs, gs, wq)):
        assert y.shape == (m, d) and y.dtype == dtype
        assert torch.all(y == 0)


@pytest.mark.parametrize("m,d,f,gs", GROUPED_CASES)
@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_grouped_ffn_plain_matches_reference(m, d, f, gs, on, dtype):
    """The port's pad slot has no weights; the reference runs the pad
    slot's zero rows through slot 0's weights (``pad_row``).  Both give 0
    there, and the same products elsewhere."""
    n_w = len(gs) - 1
    rng = np.random.default_rng(m + d + f)
    xs = rng.standard_normal((m, d)).astype(np.float32)
    xs[sum(gs[:-1]):] = 0                          # the pad slot's rows
    w = {"w_gate": _stack(m, n_w, d, f), "w_up": _stack(m + 1, n_w, d, f),
         "w_down": _stack(m + 2, n_w, f, d)}
    gs_m = np.asarray(gs, np.int32) * int(on)
    pad = lambda a: jnp.concatenate([a, a[:1]], axis=0)   # noqa: E731
    ref = jax.jit(partial(jmoe._grouped_ffn, act=jax.nn.silu))(
        jnp.asarray(xs).astype(dtype), jnp.asarray(gs_m),
        *(pad(jnp.asarray(w[n]).astype(dtype))
          for n in ("w_gate", "w_up", "w_down")))
    got = tops.grouped_ffn(tensor_from_numpy(np.asarray(
        jnp.asarray(xs).astype(dtype)), "cpu"), torch.from_numpy(gs_m),
        {n: tensor_from_numpy(np.asarray(jnp.asarray(v).astype(dtype)),
                              "cpu") for n, v in w.items()})
    ya, ra = to_numpy(got), np.asarray(ref, np.float32)
    if not on:
        assert np.all(ya == 0) and np.all(ra == 0)
    if dtype == jnp.bfloat16:
        # bf16 products and casts round at other places in the two
        # frameworks' CPU matmuls: one bf16 ulp (2^-7 relative) of the
        # output's largest magnitude
        np.testing.assert_allclose(ya, ra, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(ra).max())
    else:
        np.testing.assert_allclose(ya, ra, rtol=1e-5, atol=1e-4)


def _moe_setup():
    cfg_j = jreduced(jget("moonshot-v1-16b-a3b"))
    cfg_t = reduced(get_config("moonshot-v1-16b-a3b"))
    e = cfg_j.moe
    d, n_e, f = cfg_j.d_model, e.num_experts, e.d_ff
    rng = np.random.default_rng(1)
    p = {"router": rng.standard_normal((d, n_e)) * 0.2,
         "w_gate": rng.standard_normal((n_e, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((n_e, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((n_e, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = (rng.standard_normal((2, 24, d)) * 0.5).astype(np.float32)
    mod = rng.random((2, 24)) < 0.6
    return cfg_j, cfg_t, p, x, mod


def _forced(policy, on: bool, full_like):
    def wrapped(*a, **kw):
        dec = policy(*a, **kw)
        return dec._replace(use_fp4=full_like(dec.use_fp4, on))
    return wrapped


@pytest.mark.parametrize("mode", ["dispatch", "broadcast"])
@pytest.mark.parametrize("on", [True, False])
def test_ep_moe_forced_decision_matches_reference(monkeypatch, mode, on):
    """The decision forced against the policy (on under a closed gate, off
    where FP4 would fire), in both packages: the same output and stats."""
    cfg_j, cfg_t, p, x, mod = _moe_setup()
    if mode == "broadcast":                  # decode: one token per row
        x = x.reshape(-1, 1, x.shape[-1])[-12:]
        mod = mod.reshape(-1, 1)[-12:]
    kw = BF16 if on else FP4
    monkeypatch.setattr(jmoe, "realb_policy",
                        _forced(jmoe.realb_policy, on, jnp.full_like))
    monkeypatch.setattr(tmoe, "realb_policy",
                        _forced(tmoe.realb_policy, on, torch.full_like))
    m = np.zeros((1, 4), np.float32)
    y_j, m_j, aux_j = jax.jit(partial(jmoe.ep_moe_forward, cfg=cfg_j,
                                      rcfg=JCfg(**kw), mode=mode))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        m_state=jnp.asarray(m), modality=jnp.asarray(mod))
    y_t, m_t, aux_t = tmoe.ep_moe_forward(
        params_from_numpy(p, "cpu"), torch.from_numpy(x), cfg_t, TCfg(**kw),
        torch.from_numpy(m), torch.from_numpy(mod), mode=mode)
    assert float(aux_t["fp4_ranks"]) == (4.0 if on else 0.0)
    for k in ("load_d", "vis_d", "fp4_ranks", "gate_open", "drop_frac"):
        assert np.array_equal(np.asarray(aux_j[k], np.float32).reshape(-1),
                              aux_t[k].numpy().astype(np.float32)
                              .reshape(-1)), k
    assert np.array_equal(np.asarray(m_j), m_t.numpy())
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-4)


def test_host_sync_counter_is_gone():
    """The decision is no longer read on the host, so nothing counts such
    reads; the forward's freedom from syncs is checked on the card."""
    assert not hasattr(tmoe, "host_syncs")
    f = tmoe._use_fp4(torch.tensor([False, True, False, False]), 1, 4)
    assert torch.is_tensor(f) and f.dim() == 0 and bool(f)

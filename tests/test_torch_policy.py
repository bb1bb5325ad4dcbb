"""The port's ReaLB policy against the jitted reference, exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ReaLBConfig as JCfg
from repro.core import policy as jpol
from repro_torch.configs.base import ReaLBConfig as TCfg
from repro_torch.core import policy as tpol

CONFIGS = [
    dict(),                                          # paper defaults
    dict(gate_gamma=512, md_init=0.0, adaptive=False),
    dict(gate_gamma=64, tau=1.2, md_add=0.3, md_mult=0.25, md_min=0.1),
    dict(enabled=False, gate_gamma=8),
]


@pytest.mark.parametrize("kw", CONFIGS)
@pytest.mark.parametrize("ranks", [1, 3, 4, 8])
def test_policy_decisions_exact(kw, ranks):
    rng = np.random.default_rng(ranks * 31 + len(kw))
    jcfg, tcfg = JCfg(**kw), TCfg(**kw)
    step = jax.jit(lambda l, v, m: jpol.realb_policy(l, v, m, jcfg))
    for _ in range(40):
        scale = rng.choice([1, 30, 900])
        load = rng.integers(0, scale + 1, ranks).astype(np.float32)
        vis = np.floor(load * rng.random(ranks)).astype(np.float32)
        m = rng.random(ranks).astype(np.float32)
        ref = step(jnp.asarray(load), jnp.asarray(vis), jnp.asarray(m))
        got = tpol.realb_policy(torch.from_numpy(load), torch.from_numpy(vis),
                                torch.from_numpy(m), tcfg)
        for name in ("use_fp4", "hotspots", "gate_open"):
            assert np.array_equal(np.asarray(getattr(ref, name)),
                                  getattr(got, name).numpy()), name
        for name in ("ib_d", "ib_global", "r_v", "m_new"):
            a = np.asarray(getattr(ref, name), np.float32)
            b = getattr(got, name).numpy().astype(np.float32)
            assert np.array_equal(a.view(np.uint32), b.view(np.uint32)), name


def test_init_m_state_and_gate():
    cfg = TCfg(md_init=0.25, gate_gamma=100)
    m = tpol.init_m_state(1, 4, cfg, device="cpu")
    ref = jpol.init_m_state(1, 4, JCfg(md_init=0.25, gate_gamma=100))
    assert np.array_equal(np.asarray(ref), m.numpy())
    for tokens in (99.0, 100.0, 101.0):
        assert bool(tpol.lb_gate(torch.tensor(tokens), cfg)) == bool(
            jpol.lb_gate(jnp.float32(tokens), JCfg(gate_gamma=100)))

"""Temperature sampling in the port's engine.  JAX's PRNG cannot be
matched, so the draws are held to their distribution and their seeding:
greedy (T = 0) equals the reference's ``Engine._sample``, one seed gives
one stream of draws and another seed another, and 20,000 draws pass a
chi-square test against ``softmax(logits / T)``."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.analysis.sentinel import NULL_SENTINEL
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import ReaLBConfig, get_config, reduced
from repro_torch.models import transformer as ttf
from repro_torch.serving.engine import Engine, sample_tokens
from repro_torch.workloads import arrivals, multimodal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs one worker per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_greedy_equals_reference_sample():
    """T = 0: the reference engine's greedy tokens (the first maximum on
    ties) on random logits and on rows with tied maxima."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 50)).astype(np.float32)
    logits[1, [3, 17, 40]] = 9.0                      # a three-way tie
    logits[4, :] = 0.0                                # all tied
    ref_self = types.SimpleNamespace(temperature=0.0, sentinel=NULL_SENTINEL)
    ref = JEngine._sample(ref_self, jnp.asarray(logits))
    gen = torch.Generator().manual_seed(0)
    got = sample_tokens(torch.from_numpy(logits), 0.0, gen).numpy()
    assert np.array_equal(ref, got)
    assert got[1] == 3 and got[4] == 0


def test_draws_follow_softmax_at_temperature():
    """20,000 draws from fixed logits at T = 0.7 against
    ``softmax(logits / 0.7)``: chi-square p > 1e-3."""
    logits = torch.tensor([1.2, -0.4, 0.0, 2.0, 0.7, -1.5, 0.3, 1.0])
    temp, n = 0.7, 20_000
    gen = torch.Generator().manual_seed(1)
    draws = sample_tokens(logits.expand(n, -1), temp, gen).numpy()
    observed = np.bincount(draws, minlength=logits.numel())
    probs = torch.softmax(logits.double() / temp, dim=-1).numpy()
    _, p = stats.chisquare(observed, probs * n)
    assert p > 1e-3, (p, observed, probs * n)
    # the same check would fail on the greedy rule or on T = 1
    _, p1 = stats.chisquare(observed, torch.softmax(
        logits.double(), dim=-1).numpy() * n)
    assert p1 < 1e-3


def _serve(seed, temperature=0.7):
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    params = ttf.init_model(cfg, seed=0, device="cpu")
    specs = multimodal.make_stream(
        multimodal.profile("MMMU"),
        arrivals.arrival_times(arrivals.ArrivalConfig(
            kind="poisson", rate=40.0, n_requests=3, seed=0)),
        cfg.vocab_size, seed=1, max_prompt=16)
    clock = arrivals.VirtualClock()
    eng = Engine(cfg, params, ReaLBConfig(gate_gamma=16), max_slots=4,
                 max_len=64, prefill_budget=16, virtual_ep=4,
                 temperature=temperature, seed=seed, clock=clock,
                 cost_model=arrivals.IterationCostModel(), device="cpu")
    for spec in specs:
        eng.submit(spec.to_request())
    done = eng.run()
    assert len(done) == len(specs)
    return {r.uid: r.generated for r in done}


def test_seed_fixes_the_draws():
    """The same seed gives the same tokens; another seed other tokens; and
    sampling at T = 0.7 departs from greedy decoding."""
    first, again, other = _serve(0), _serve(0), _serve(1)
    assert first == again
    assert first != other
    assert first != _serve(0, temperature=0.0)

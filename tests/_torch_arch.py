"""Shared parity helpers of the port's per-architecture tests
(``test_torch_dense.py``, ``test_torch_mla.py``, ``test_torch_ssm_train.py``,
``test_torch_vlm.py``, ``test_torch_encdec.py``): one reduced model built
once for both packages, the reference's jitted forwards and gradients, the
spread tolerance, one seeded MMMU stream served by both engines in virtual
time, and, for a stack with cross-attention layers, the seeded memory its
batches and requests carry (:func:`memory_batch`).

The spread tolerance.  Through a whole random model the reference's own
output is ill-conditioned: scaling its embedding by ``1 ± 2^-22`` (two f32
ulps) moves reduced qwen1.5-0.5b's prefill logits by 6.7e-5 of their max
(sharp softmaxes: the fan-in init of ``wq``/``wk`` is over the head axis).
So a whole-model value is held to the larger of ``tol`` x its max and
``SPREAD`` x the reference's largest change under those perturbations:
the port must stay within the reference's own f32 noise
(``test_torch_train.py``'s method).  A memory (vision or frame embeddings)
moves with the embedding in those perturbations: it is an input as the
embedded tokens are.  One layer on one input carries no
such amplification and is held at the plain tolerance.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import transformer as jtf
from repro.serving.engine import Engine as JEngine
from repro.serving.scheduler import Request as JRequest
from repro.workloads import (ArrivalConfig, IterationCostModel, VirtualClock,
                             arrival_times, make_stream, profile)
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.models import transformer as ttf
from repro_torch.optim.grad_utils import value_and_grad
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.scheduler import Request as TRequest
from repro_torch.workloads import arrivals as t_arrivals
from repro_torch.workloads import multimodal as t_multimodal

SPREAD = 4.0
PERTURB = (1 + 2.0 ** -22, 1 - 2.0 ** -22)
FWD_TOL = 5e-5              # of max |reference|
RTOL, ATOL_REL = 1e-4, 3e-5  # test_torch_train.py's (one layer, gradients)
B, S, L = 3, 12, 24
ENGINE = dict(max_slots=4, max_len=40, prefill_budget=16, virtual_ep=4)
N_REQ, MAX_PROMPT = 5, 16


class Model:
    """Reduced ``arch`` in both packages on the reference's weights."""

    def __init__(self, arch, published=False, **overrides):
        self.arch = arch
        if published:       # the published widths, only ``overrides`` cut
            kw = dict(overrides, param_dtype="float32", remat="none")
            self.cfg_j = dataclasses.replace(jget(arch), **kw)
            self.cfg_t = dataclasses.replace(get_config(arch), **kw)
        else:
            self.cfg_j = jreduced(jget(arch), **overrides)
            self.cfg_t = reduced(get_config(arch), **overrides)
        self.params = jtf.init_model(self.cfg_j, jax.random.PRNGKey(0))
        self.npp = jax.tree.map(np.asarray, self.params)
        self.tparams = params_from_numpy(self.npp, "cpu")

    def perturbed(self):
        return [{**self.params, "embed": self.params["embed"] * f}
                for f in PERTURB]


MEMORY_KEYS = ("vision_embeds", "enc_embeds")


def memory_batch(cfg, rng, b):
    """The seeded memory of a stack's cross-attention layers for ``b``
    rows: a VLM's ``vision_embeds [b, n_vision_tokens, D]`` (normal, sigma
    0.02, as the stub frontend's), an encoder-decoder's ``enc_embeds
    [b, enc_seq_len, D]`` (normal, sigma 1); ``{}`` (no draw) for any other
    stack."""
    if cfg.family == "vlm":
        return {"vision_embeds": rng.normal(
            0, 0.02, (b, cfg.n_vision_tokens, cfg.d_model)).astype(
                np.float32)}
    if cfg.is_encdec:
        return {"enc_embeds": rng.normal(
            0, 1.0, (b, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)}
    return {}


def perturbed_batches(batch):
    """``batch`` with its memory scaled as :attr:`Model.perturbed` scales
    the embedding, one a factor of ``PERTURB``."""
    return [{k: v * f if k in MEMORY_KEYS else v for k, v in batch.items()}
            for f in PERTURB]


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: to_numpy(tree) if torch.is_tensor(tree)
            else np.asarray(tree)}


def layout(tree, prefix=""):
    """``{key path: (shape, dtype name)}`` of a tree of tensors, arrays or
    ``jax.ShapeDtypeStruct``s (``jax.eval_shape``'s)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(layout(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def within_spread(j, t, perturbed, what, tol=FWD_TOL):
    """``t`` within the larger of ``tol`` x max|j| and ``SPREAD`` x the
    reference's largest change over ``perturbed`` (its values there);
    returns the gap over the bound."""
    j = np.asarray(j)
    t = to_numpy(t) if torch.is_tensor(t) else np.asarray(t)
    spread = max(float(np.abs(np.asarray(p) - j).max()) for p in perturbed)
    bound = max(tol * float(np.abs(j).max()), SPREAD * spread)
    gap = float(np.abs(t - j).max())
    assert gap <= bound, (what, gap, bound, spread)
    return gap / bound


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def prefill_then_decode(model, rcfg_kw, rng, seq=S, cache_len=L):
    """Prefill of ``B x seq`` tokens (with the stack's memory, if any) then
    two decodes (row 1 idle: its write drops) in both packages, each
    against the reference within the spread tolerance (logits and every
    cache entry), ``m_state`` and the statistics exact; returns the port's
    last cache."""
    jr, tr = JCfg(**rcfg_kw), TCfg(**rcfg_kw)
    tokens = rng.integers(0, model.cfg_j.vocab_size, (B, seq)).astype(
        np.int32)
    batch = {"tokens": tokens, "modality": rng.random((B, seq)) < 0.6}
    batch.update(memory_batch(model.cfg_t, rng, B))
    m = np.full((1, 4), jr.md_init, np.float32)
    pre = jax.jit(partial(jtf.prefill_forward, cfg=model.cfg_j, rcfg=jr,
                          cache_len=cache_len))
    dec = jax.jit(partial(jtf.decode_forward, cfg=model.cfg_j, rcfg=jr))
    jb = jax.tree.map(jnp.asarray, batch)
    rj = pre(model.params, batch=jb, m_state=jnp.asarray(m))
    rp = [pre(p, batch=b, m_state=jnp.asarray(m))
          for p, b in zip(model.perturbed(), perturbed_batches(jb))]
    rt = ttf.prefill_forward(model.tparams, model.cfg_t, tr,
                             torch_batch(batch), torch.from_numpy(m),
                             cache_len=cache_len)
    _hold(rj, rp, rt, "prefill")
    states = [rj] + rp
    for step in range(2):
        db = {"tokens": rng.integers(0, model.cfg_j.vocab_size, (B, 1))
              .astype(np.int32),
              "pos": np.array([seq + step, cache_len, seq + step], np.int32),
              "modality": np.array([[True], [False], [False]]),
              "valid": np.array([[True], [False], [True]])}
        jdb = jax.tree.map(jnp.asarray, db)
        states = [dec(p, batch=jdb, cache=r.cache, m_state=r.m_state)
                  for p, r in zip([model.params] + model.perturbed(),
                                  states)]
        rt = ttf.decode_forward(model.tparams, model.cfg_t, tr,
                                torch_batch(db), rt.cache, rt.m_state)
        _hold(states[0], states[1:], rt, f"decode {step}")
    return rt


def _hold(rj, rp, rt, what):
    within_spread(rj.logits, rt.logits, [r.logits for r in rp],
                  f"{what} logits")
    cj, ct = flat(rj.cache), flat(rt.cache)
    assert set(cj) == set(ct)
    for n in cj:
        within_spread(cj[n], ct[n], [flat(r.cache)[n] for r in rp],
                      f"{what} cache {n}")
    assert np.array_equal(np.asarray(rj.m_state), rt.m_state.numpy())
    for k in ("moe_stats", "expert_stats", "slot_stats"):
        assert np.array_equal(np.asarray(rj.aux[k]), rt.aux[k].numpy()), k


def train_grads_match(model, rcfg_kw, rng, remat="none"):
    """``train_loss`` and its gradient against ``jax.value_and_grad`` of
    the reference's (the stack's memory in the batch, if any): the loss at
    ``RTOL``, each gradient leaf within the spread (at ``ATOL_REL``).
    Returns the largest gap over its bound."""
    labels = rng.integers(0, model.cfg_j.vocab_size, (4, 16)).astype(
        np.int32)
    labels[rng.random((4, 16)) < 0.25] = -1
    batch = {"tokens": rng.integers(0, model.cfg_j.vocab_size, (4, 16))
             .astype(np.int32), "labels": labels,
             "modality": rng.random((4, 16)) < 0.6}
    batch.update(memory_batch(model.cfg_t, rng, 4))
    jr, tr = JCfg(**rcfg_kw), TCfg(**rcfg_kw)
    m = np.full((1, 4), jr.md_init, np.float32)
    fn = jax.jit(jax.value_and_grad(partial(
        jtf.train_loss, cfg=model.cfg_j, rcfg=jr), has_aux=True))
    jb = jax.tree.map(jnp.asarray, batch)
    (loss_j, (m_j, _)), g_j = fn(model.params, batch=jb,
                                 m_state=jnp.asarray(m))
    g_p = [flat(fn(p, batch=b, m_state=jnp.asarray(m))[1])
           for p, b in zip(model.perturbed(), perturbed_batches(jb))]
    cfg_t = dataclasses.replace(model.cfg_t, remat=remat)
    (loss_t, (m_t, _)), g_t = value_and_grad(
        ttf.train_loss, model.tparams, cfg_t, tr, torch_batch(batch),
        torch.from_numpy(m))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL)
    assert np.array_equal(np.asarray(m_j), m_t.numpy())
    gj, gt = flat(g_j), flat(g_t)
    assert set(gj) == set(gt)
    worst = 0.0
    for name in gj:
        worst = max(worst, within_spread(gj[name], gt[name],
                                         [g[name] for g in g_p],
                                         f"grad {name}", tol=ATOL_REL))
    return worst


def _serve(engine, specs, clock):
    pending = sorted(specs, key=lambda s: s.arrival)
    while len(engine.scheduler.finished) < len(specs):
        now = clock()
        while pending and pending[0].arrival <= now:
            engine.submit(pending.pop(0).to_request())
        if engine.scheduler.idle and pending:
            clock.advance(pending[0].arrival - now)
            continue
        engine.step()
    return {r.uid: r for r in engine.scheduler.finished}


def engines_agree(model, policy):
    """Both engines on one seeded 5-request MMMU stream of <= 16-token
    prompts in virtual time: the same tokens, times, IterStats and
    ``m_state``.  Returns the port's engine."""
    acfg = dict(kind="poisson", rate=40.0, n_requests=N_REQ, seed=0)
    specs_j = make_stream(profile("MMMU"), arrival_times(ArrivalConfig(
        **acfg)), model.cfg_j.vocab_size, seed=1, max_prompt=MAX_PROMPT)
    specs_t = t_multimodal.make_stream(
        t_multimodal.profile("MMMU"),
        t_arrivals.arrival_times(t_arrivals.ArrivalConfig(**acfg)),
        model.cfg_t.vocab_size, seed=1, max_prompt=MAX_PROMPT)
    clock_j = VirtualClock()
    eng_j = JEngine(model.cfg_j, model.params, JCfg(**policy),
                    clock=clock_j, cost_model=IterationCostModel(), **ENGINE)
    done_j = _serve(eng_j, specs_j, clock_j)
    clock_t = t_arrivals.VirtualClock()
    eng_t = TEngine(model.cfg_t, model.tparams, TCfg(**policy),
                    clock=clock_t, cost_model=t_arrivals.IterationCostModel(),
                    device="cpu", **ENGINE)
    done_t = _serve(eng_t, specs_t, clock_t)
    assert eng_j.chunked == eng_t.chunked
    assert set(done_j) == set(done_t) == set(range(N_REQ))
    for uid in done_j:
        rj, rt = done_j[uid], done_t[uid]
        assert rj.generated == rt.generated, uid
        assert rj.first_token_time == rt.first_token_time, uid
        assert rj.finish_time == rt.finish_time, uid
    assert len(eng_j.stats) == len(eng_t.stats)
    fields = [f.name for f in dataclasses.fields(eng_t.stats[0])]
    for i, (sj, st) in enumerate(zip(eng_j.stats, eng_t.stats)):
        for f in fields:
            assert getattr(sj, f) == getattr(st, f), (i, f)
    assert np.array_equal(np.asarray(eng_j.m_state), eng_t.m_state.numpy())
    return eng_t


def memory_requests(cfg, rng, n_req, without=()):
    """``n_req`` seeded requests of 8-16 prompt tokens (a VLM's first
    ``n_vision_tokens`` flagged vision), 3-6 new tokens each, each with
    its memory rows in ``vision_embeds`` (none for the uids in
    ``without``), arriving 5 ms apart: ``(uid, tokens, modality,
    max_new, embeds, arrival)`` tuples, from which both packages'
    ``Request`` objects are built."""
    out = []
    for uid in range(n_req):
        s = int(rng.integers(max(8, cfg.n_vision_tokens), 17))
        tokens = rng.integers(0, cfg.vocab_size, s).astype(np.int32)
        modality = np.arange(s) < cfg.n_vision_tokens
        mem = memory_batch(cfg, rng, 1)
        embeds = None if uid in without else next(iter(mem.values()))[0]
        out.append((uid, tokens, modality, int(rng.integers(3, 7)), embeds,
                    0.005 * uid))
    return out


def _serve_requests(engine, make, rows, clock):
    """``rows`` (:func:`memory_requests`) submitted at their arrival times
    in virtual time, built by ``make`` (a ``Request`` class)."""
    pending = sorted(rows, key=lambda r: r[5])
    while len(engine.scheduler.finished) < len(rows):
        now = clock()
        while pending and pending[0][5] <= now:
            uid, tokens, modality, max_new, embeds, arrival = pending.pop(0)
            engine.submit(make(uid=uid, tokens=tokens.copy(),
                               modality=modality.copy(),
                               max_new_tokens=max_new,
                               vision_embeds=None if embeds is None
                               else embeds.copy(), arrival_time=arrival))
        if engine.scheduler.idle and pending:
            clock.advance(pending[0][5] - now)
            continue
        engine.step()
    return {r.uid: r for r in engine.scheduler.finished}


def memory_engines_agree(model, policy, rows):
    """Both engines on ``rows`` (:func:`memory_requests`) in virtual time:
    the same tokens, times, IterStats and ``m_state``, both prefilling one
    shot.  Returns the port's engine and its finished requests."""
    eng_j = JEngine(model.cfg_j, model.params, JCfg(**policy),
                    clock=VirtualClock(), cost_model=IterationCostModel(),
                    **ENGINE)
    done_j = _serve_requests(eng_j, JRequest, rows, eng_j.clock)
    eng_t = TEngine(model.cfg_t, model.tparams, TCfg(**policy),
                    clock=t_arrivals.VirtualClock(),
                    cost_model=t_arrivals.IterationCostModel(),
                    device="cpu", **ENGINE)
    done_t = _serve_requests(eng_t, TRequest, rows, eng_t.clock)
    assert eng_j.chunked is eng_t.chunked is False
    assert set(done_j) == set(done_t) == {r[0] for r in rows}
    for uid in done_j:
        rj, rt = done_j[uid], done_t[uid]
        assert rj.generated == rt.generated, uid
        assert rj.first_token_time == rt.first_token_time, uid
        assert rj.finish_time == rt.finish_time, uid
    assert len(eng_j.stats) == len(eng_t.stats)
    fields = [f.name for f in dataclasses.fields(eng_t.stats[0])]
    for i, (sj, st) in enumerate(zip(eng_j.stats, eng_t.stats)):
        for f in fields:
            assert getattr(sj, f) == getattr(st, f), (i, f)
    assert np.array_equal(np.asarray(eng_j.m_state), eng_t.m_state.numpy())
    return eng_t, done_t


def spec_param_count(spec, n_blocks):
    """Elements of a ``model_spec`` tree (its blocks stacked ``n_blocks``
    times), without allocating it."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return int(np.prod(tree.shape))
    return sum(count(v) * (n_blocks if k == "blocks" else 1)
               for k, v in spec.items())


def smoke(model, rng):
    """The reference's ``test_arch_smoke`` in the port: one train loss, a
    prefill and a decode on the reduced config (with its memory, if any),
    finite and shaped."""
    cfg, rcfg = model.cfg_t, TCfg(gate_gamma=4)
    b, s = 2, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                              .astype(np.int32))
    mem = torch_batch(memory_batch(cfg, rng, b))
    m = torch.full((1, 1), rcfg.md_init)
    loss, _ = ttf.train_loss(model.tparams, cfg, rcfg,
                             {"tokens": tokens, "labels": tokens, **mem}, m)
    assert torch.isfinite(loss) and float(loss) > 0
    res = ttf.prefill_forward(model.tparams, cfg, rcfg,
                              {"tokens": tokens, **mem}, m,
                              cache_len=s + 4)
    assert res.logits.shape == (b, cfg.vocab_size)
    assert torch.isfinite(res.logits).all()
    res2 = ttf.decode_forward(model.tparams, cfg, rcfg, {
        "tokens": tokens[:, :1], "pos": torch.full((b,), s,
                                                   dtype=torch.int32)},
        res.cache, res.m_state)
    assert res2.logits.shape == (b, cfg.vocab_size)
    assert torch.isfinite(res2.logits).all()


def consistency(model, rng):
    """The reference's ``test_prefill_decode_consistency`` in the port:
    decode(token s | cache of s tokens) equals prefill(s + 1 tokens)
    within rtol = atol = 2e-3 (both prefills on the same memory, if
    any)."""
    cfg, params, rcfg = model.cfg_t, model.tparams, TCfg(gate_gamma=4)
    b, s = 2, 12
    full = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1))
                            .astype(np.int32))
    mem = torch_batch(memory_batch(cfg, rng, b))
    m = torch.full((1, 1), rcfg.md_init)
    ref = ttf.prefill_forward(params, cfg, rcfg, {"tokens": full, **mem}, m,
                              cache_len=s + 1)
    res = ttf.prefill_forward(params, cfg, rcfg,
                              {"tokens": full[:, :s], **mem}, m,
                              cache_len=s + 1)
    dec = ttf.decode_forward(params, cfg, rcfg, {
        "tokens": full[:, s:], "pos": torch.full((b,), s,
                                                 dtype=torch.int32)},
        res.cache, res.m_state)
    np.testing.assert_allclose(dec.logits.numpy(), ref.logits.numpy(),
                               rtol=2e-3, atol=2e-3)


def card_check_is_not_chaotic(arch, n_layers, rng, margin=0.1,
                              **cut):
    """``chip_smoke.consistency_f32``'s check where the card runs it:
    ``arch`` at its published widths cut to its first ``n_layers`` layers
    (and ``cut``'s other fields, such as an encoder-decoder's
    ``n_enc_layers``; vocabulary cut to 8192), f32, B = 2, s = 48, on the
    stack's seeded memory if it has one.  The reference's own prefill(s +
    1) logits move by at most ``margin`` of the bound ``2e-3 + 2e-3 x
    |logit|`` when its embedding (and memory) moves by two f32 ulps, so a
    gap past the bound there is no rounding noise; and the port's
    decode(token s | cache of s) lies within the bound of the reference's
    prefill(s + 1).  Returns (the spread's, the gap's) share of the
    bound."""
    model = Model(arch, published=True, n_layers=n_layers, vocab_size=8192,
                  **cut)
    b, s = 2, 48
    tokens = rng.integers(0, 8192, (b, s + 1)).astype(np.int32)
    mem = memory_batch(model.cfg_t, rng, b)
    jr, tr = JCfg(), TCfg()
    m = np.zeros((1, 4), np.float32)
    pre = jax.jit(lambda p, mem: jtf.prefill_forward(
        p, model.cfg_j, jr, {"tokens": jnp.asarray(tokens), **mem},
        jnp.asarray(m), cache_len=s + 1).logits)
    ref = np.asarray(pre(model.params, mem))
    bound = 2e-3 + 2e-3 * np.abs(ref)
    spread = max(float((np.abs(np.asarray(pre(p, pm)) - ref) / bound).max())
                 for p, pm in zip(model.perturbed(), perturbed_batches(mem)))
    res = ttf.prefill_forward(model.tparams, model.cfg_t, tr,
                              {"tokens": torch.from_numpy(tokens[:, :s]),
                               **torch_batch(mem)},
                              torch.from_numpy(m), cache_len=s + 1)
    dec = ttf.decode_forward(model.tparams, model.cfg_t, tr, {
        "tokens": torch.from_numpy(tokens[:, s:]),
        "pos": torch.full((b,), s, dtype=torch.int32)},
        res.cache, res.m_state).logits
    gap = float((np.abs(dec.numpy() - ref) / bound).max())
    assert spread <= margin, (arch, n_layers, "spread", spread)
    assert gap <= 1.0, (arch, n_layers, "gap", gap)
    return spread, gap

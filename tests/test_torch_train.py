"""The port's training path against the reference's: each layer's
gradient, and ``train_loss`` with its gradient on reduced moonshot (f32),
against ``jax.value_and_grad(repro.models.transformer.train_loss)``; the
``remat`` policies; three AdamW steps of ``benchmarks/acc_proxy.py``'s
recipe; the loss falling as in
``tests/test_system.py::test_training_reduces_loss``; attention's gradient
past 2048 keys.

Tolerances.  One layer's gradient is held at ``test_torch_model.py``'s
``RTOL 1e-4, ATOL_REL 3e-5`` (measured within 1.7e-5 of each leaf's max).
Through the whole model the reference's own gradient is ill-conditioned:
scaling its embedding by 1 + 2^-22 (two f32 ulps) moves leaves by up to
~3e-3 of their max, so the f32 ulp differences between the two packages
(transcendentals, summation order) move the port's as far.  The model's
gradients are therefore held to the larger of ``ATOL_REL`` x a leaf's max
and ``SPREAD`` x the reference's own change under that perturbation (either
sign): the port must stay within the reference's own f32 noise.  The same
holds for three AdamW steps, whose first, sign-like updates turn gradient
noise into steps of either direction and whose routing then flips near
ties: the reference's perturbed runs end as far from its unperturbed one as
the port does."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ReaLBConfig as JCfg
from repro.configs import TrainConfig as JTrain
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.data.pipeline import DataConfig as JData
from repro.data.pipeline import multimodal_batch as jmultimodal_batch
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.data.pipeline import DataConfig, DataLoader
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.grad_utils import value_and_grad

ARCH = "moonshot-v1-16b-a3b"
# test_torch_model.py's tolerance: f32 through 4 layers, transcendental
# ulps and another summation order; an element's error scales with its
# tensor's largest value
RTOL, ATOL_REL = 1e-4, 3e-5
# ReaLB off; on with the gate open and FP4 voted every layer (forced off
# in training, counted in fp4_ranks)
POLICIES = {"off": dict(enabled=False),
            "on": dict(gate_gamma=8, md_init=0.0, adaptive=False)}
METRICS = ("ce", "lb_loss", "drop_frac")
SPREAD = 4.0
PERTURB = (1 + 2.0 ** -22, 1 - 2.0 ** -22)
# z_loss is the mean square of lse = logsumexp(log softmax) = log(1), which
# both sides compute as f32 rounding noise of a few ulps of 1: below
# (8 * 2^-23)^2 ~ 9e-13 on both, and held to that, not to a relative
# tolerance of noise
Z_ATOL = (8 * 2.0 ** -23) ** 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    cfg_j, cfg_t = jreduced(jget(ARCH)), reduced(get_config(ARCH))
    params = jtf.init_model(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, params, params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def _batch(case):
    """("reduced": 4 x 16 random tokens, a quarter of the labels masked, a
    virtual EP group of 4; "acc_proxy": acc_proxy.py's 16 x 64
    multimodal batch, m_state [1, 1])."""
    if case == "acc_proxy":
        dc = JData(vocab_size=512, seq_len=64, global_batch=16)
        b = jmultimodal_batch(dc, 0)
        return b, 1
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 512, (4, 16)).astype(np.int32)
    labels[rng.random((4, 16)) < 0.25] = -1
    return {"tokens": rng.integers(0, 512, (4, 16)).astype(np.int32),
            "labels": labels, "modality": rng.random((4, 16)) < 0.6}, 4


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _compare(j, t, what, rtol=RTOL, atol_rel=ATOL_REL):
    j = np.asarray(j)
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    np.testing.assert_allclose(t, j, err_msg=what, rtol=rtol,
                               atol=atol_rel * float(np.abs(j).max()))


def _within_spread(j, t, perturbed, what):
    """``t`` within the larger of ``ATOL_REL`` x max|j| and ``SPREAD`` x
    the reference's largest change under the embedding perturbations
    (``perturbed``: the reference's values there)."""
    j = np.asarray(j)
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    spread = max(float(np.abs(np.asarray(p) - j).max()) for p in perturbed)
    tol = max(ATOL_REL * float(np.abs(j).max()), SPREAD * spread)
    gap = float(np.abs(t - j).max())
    assert gap <= tol, (what, gap, tol, spread)


def _perturbed_embed(params, factor):
    return {**params, "embed": params["embed"] * factor}


_JIT = {}


def _reference(cfg_j, rcfg, params, batch, m):
    key = (cfg_j, rcfg)
    if key not in _JIT:
        _JIT[key] = jax.jit(jax.value_and_grad(
            partial(jtf.train_loss, cfg=cfg_j, rcfg=rcfg), has_aux=True))
    return _JIT[key](params, batch=jax.tree.map(jnp.asarray, batch),
                     m_state=jnp.asarray(m))


@pytest.mark.parametrize("case", ["reduced", "acc_proxy"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_train_loss_and_grads_match_reference(model, case, policy):
    cfg_j, cfg_t, params, tparams = model
    kw = POLICIES[policy]
    batch, vep = _batch(case)
    m = np.full((1, vep), JCfg(**kw).md_init, np.float32)
    (loss_j, (m_j, met_j)), g_j = _reference(cfg_j, JCfg(**kw), params,
                                             batch, m)
    ops.reset_launch_counts()
    (loss_t, (m_t, met_t)), g_t = value_and_grad(
        ttf.train_loss, tparams, cfg_t, TCfg(**kw),
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        torch.from_numpy(m))
    _compare(loss_j, loss_t, "loss")
    for k in METRICS:
        _compare(met_j[k], met_t[k], k)
    z_j, z_t = float(met_j["z_loss"]), float(met_t["z_loss"])
    assert 0 <= z_j < Z_ATOL and 0 <= z_t < Z_ATOL, (z_j, z_t)
    for k in ("ib_global", "fp4_ranks", "gate_open", "split_frac"):
        assert float(met_t[k]) == float(met_j[k]), k
    if policy == "on" and vep > 1:
        assert float(met_t["fp4_ranks"]) > 0      # voted, and forced off
    assert np.array_equal(np.asarray(m_j), m_t.numpy())
    assert not m_t.requires_grad
    gj, gt = _flat(jax.tree.map(np.asarray, g_j)), _flat(g_t)
    assert set(gj) == set(gt)
    g_p = [_flat(jax.tree.map(np.asarray, _reference(
        cfg_j, JCfg(**kw), _perturbed_embed(params, f), batch, m)[1]))
        for f in PERTURB]
    for name in gj:
        _within_spread(gj[name], gt[name], [g[name] for g in g_p],
                       f"grad {name}")
    assert ops.launch_counts()["quantize_fp4"] == 0   # CPU: plain versions


@pytest.mark.parametrize("where", ["prefix", "moe", "moe_drops"])
@pytest.mark.parametrize("policy", list(POLICIES))
def test_layer_grads_match_reference(model, where, policy):
    """One layer in "train" mode (the leading dense layer, or the first MoE
    block; "moe_drops" at capacity factor 0.5, so that the dispatch drops
    assignments into the port's spare rows) on the same input and
    cotangent: d x and every parameter's gradient at the model tolerance;
    the output, ``m_state`` and the statistics too."""
    cfg_j, cfg_t, params, _ = model
    if where == "moe_drops":
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(
            cfg_j.moe, capacity_factor=0.5))
        cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
            cfg_t.moe, capacity_factor=0.5))
    kw = POLICIES[policy]
    npp = jax.tree.map(np.asarray, params)
    lp = npp["prefix"]["0"] if where == "prefix" \
        else jax.tree.map(lambda a: a[0], npp["blocks"]["layer0"])
    ffn = "dense" if where == "prefix" else "moe"
    rng = np.random.default_rng(5)
    b, s, d = 4, 16, cfg_t.d_model
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    w = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    mod = rng.random((b, s)) < 0.6
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(s, dtype=np.int32)[None], (b, s)))
    m = np.full((1, 4), JCfg(**kw).md_init, np.float32)

    def loss_j(lp, x):
        out = jtf.apply_layer(lp, x, cfg_j, JCfg(**kw), "attn", ffn,
                              mode="train", positions=pos, pos=None,
                              memory=None, cache_in=None,
                              m_state=jnp.asarray(m), modality=mod,
                              cache_len=0, fsdp=True)
        return jnp.sum(out[0] * w) + 0.01 * out[3]["lb_loss"], out

    (l_j, out_j), (gl_j, gx_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, lp), jnp.asarray(x))
    tl = tree_map(lambda t: t.requires_grad_(),
                        params_from_numpy(lp, "cpu"))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = ttf.apply_layer(tl, xt, cfg_t, TCfg(**kw), ffn, mode="train",
                            positions=torch.from_numpy(pos), pos=None,
                            cache_in=None, m_state=torch.from_numpy(m),
                            modality=torch.from_numpy(mod))
    l_t = (out_t[0] * torch.from_numpy(w)).sum() + 0.01 * out_t[3]["lb_loss"]
    l_t.backward()
    _compare(l_j, l_t, "loss")
    _compare(out_j[0], out_t[0], "y")
    if where == "moe_drops":
        assert float(out_t[3]["drop_frac"]) > 0.2
        assert float(out_t[3]["drop_frac"]) == float(out_j[3]["drop_frac"])
    assert out_t[1] is None
    assert np.array_equal(np.asarray(out_j[2]), out_t[2].numpy())
    for i in (4, 5, 6):
        assert np.array_equal(np.asarray(out_j[i]), out_t[i].numpy()), i
    _compare(gx_j, xt.grad, "dx")
    gj = _flat(jax.tree.map(np.asarray, gl_j))
    gt = _flat(tree_map(lambda t: t.grad, tl))
    assert set(gj) == set(gt)
    for name in gj:
        _compare(gj[name], gt[name], f"grad {name}")


def test_stats_match_reference_bitwise(model):
    """The routing statistics of ``train_forward`` (ReaLB on, a virtual EP
    group of 4) equal the reference's bit for bit."""
    cfg_j, cfg_t, params, tparams = model
    kw = POLICIES["on"]
    batch, vep = _batch("reduced")
    m = np.zeros((1, vep), np.float32)
    fwd = jax.jit(partial(jtf.train_forward, cfg=cfg_j, rcfg=JCfg(**kw)))
    res_j = fwd(params, batch=jax.tree.map(jnp.asarray, batch),
                m_state=jnp.asarray(m))
    res_t = ttf.train_forward(tparams, cfg_t, TCfg(**kw),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()},
                              torch.from_numpy(m))
    for k in ("moe_stats", "expert_stats", "slot_stats"):
        assert np.array_equal(np.asarray(res_j.aux[k]), res_t.aux[k].numpy())
    assert np.array_equal(np.asarray(res_j.m_state), res_t.m_state.numpy())


def test_remat_policies_give_equal_grads(model):
    """"none", "full" and "attn_out" give bit-equal loss, gradients,
    ``m_state`` and statistics; the recompute launches the expert FFN
    again (the CPU counts no launches, so the count is taken through a
    wrapper of the forward)."""
    _, cfg_t, _, tparams = model
    kw = POLICIES["on"]
    batch, vep = _batch("reduced")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    calls = {"n": 0}
    fwd = ops._grouped_ffn_fwd

    def counted(*a):
        calls["n"] += 1
        return fwd(*a)

    out = {}
    ops._grouped_ffn_fwd = counted
    try:
        for remat in ("none", "full", "attn_out"):
            calls["n"] = 0
            cfg = dataclasses.replace(cfg_t, remat=remat)
            (loss, (m, met)), g = value_and_grad(
                ttf.train_loss, tparams, cfg, TCfg(**kw), tb,
                torch.zeros((1, vep)))
            out[remat] = (loss, m, met, g, calls["n"])
    finally:
        ops._grouped_ffn_fwd = fwd
    n_moe = 3      # reduced moonshot: 1 dense + 3 MoE layers
    assert out["none"][4] == n_moe
    assert out["full"][4] == out["attn_out"][4] == 2 * n_moe
    base = out["none"]
    for remat in ("full", "attn_out"):
        loss, m, met, g, _ = out[remat]
        assert torch.equal(loss, base[0]) and torch.equal(m, base[1])
        for k in met:
            assert torch.equal(met[k], base[2][k]), (remat, k)
        for a, b in zip(tree_leaves(g), tree_leaves(base[3])):
            assert torch.equal(a, b), remat


def test_remat_config_copy():
    """``remat`` and ``TrainConfig`` are the reference's: the full config
    checkpoints by default, ``reduced`` turns it off."""
    assert get_config(ARCH).remat == jget(ARCH).remat == "full"
    assert reduced(get_config(ARCH)).remat == "none"
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrain())


def test_three_acc_proxy_steps_match_reference(model):
    """Three AdamW steps of acc_proxy.py's recipe (ReaLB off, lr 1e-3,
    warmup 20, 16 x 64 multimodal batches) from the reference's start state
    (``opt_state_from_numpy``): each step's loss, and the parameters and
    moments after step 3, within the reference's own spread (see the
    module docstring); ``m_state`` and the step count equal."""
    cfg_j, cfg_t, params, _ = model
    rj, rt = JCfg(enabled=False), TCfg(enabled=False)
    tj = JTrain(lr=1e-3, warmup_steps=20, total_steps=150)
    tt = TrainConfig(lr=1e-3, warmup_steps=20, total_steps=150)
    dc = JData(vocab_size=512, seq_len=64, global_batch=16)
    batches = [jmultimodal_batch(dc, s) for s in range(3)]

    @jax.jit
    def step_j(params, opt, m, batch):
        (loss, (m2, _)), g = jax.value_and_grad(
            jtf.train_loss, has_aux=True)(params, cfg_j, rj, batch, m)
        params, opt, _ = jadamw.adamw_update(params, g, opt, tj)
        return params, opt, m2, loss

    def run_j(p):
        opt, m, losses = jadamw.init_opt_state(p, tj), \
            jnp.full((1, 1), rj.md_init), []
        for b in batches:
            p, opt, m, loss = step_j(p, opt, m, jax.tree.map(jnp.asarray, b))
            losses.append(float(loss))
        return p, opt, m, losses

    p_j, opt_j, m_j, loss_j = run_j(params)
    spread = [run_j(_perturbed_embed(params, f)) for f in PERTURB]
    step_t = make_train_step(cfg_t, rt, tt)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    opt_t = opt_state_from_numpy(jax.tree.map(
        np.asarray, jadamw.init_opt_state(params, tj)), "cpu")
    m_t, loss_t = torch.full((1, 1), rt.md_init), []
    for b in batches:
        tp, opt_t, m_t, met = step_t(
            tp, opt_t, m_t, {k: torch.from_numpy(v) for k, v in b.items()})
        loss_t.append(float(met["loss"]))
    _compare(loss_j[0], torch.tensor(loss_t[0]), "loss 1")
    for s in (1, 2):
        _within_spread(loss_j[s], loss_t[s], [r[3][s] for r in spread],
                       f"loss {s + 1}")
    assert int(opt_t.step) == int(opt_j.step) == 3
    assert np.array_equal(np.asarray(m_j), m_t.numpy())
    for i, (tree_j, tree_t, what) in enumerate((
            (p_j, tp, "param"), (opt_j.mu, opt_t.mu, "mu"),
            (opt_j.nu, opt_t.nu, "nu"))):
        fj, ft = _flat(jax.tree.map(np.asarray, tree_j)), _flat(tree_t)
        fp = [_flat(jax.tree.map(np.asarray, (r[0], r[1].mu, r[1].nu)[i]))
              for r in spread]
        for name in fj:
            _within_spread(fj[name], ft[name], [f[name] for f in fp],
                           f"{what} {name}")


def test_training_reduces_loss():
    """The port's counterpart of test_system.py's: ~100 steps on the Markov
    LM stream must clearly reduce CE."""
    cfg = reduced(get_config("olmoe-1b-7b"), n_layers=2, vocab_size=128)
    rcfg = TCfg(enabled=False)
    tcfg = TrainConfig(lr=3e-3, warmup_steps=10, total_steps=100)
    params = ttf.init_model(cfg, seed=0, device="cpu")
    opt = adamw.init_opt_state(params, tcfg)
    m = torch.full((1, 1), rcfg.md_init)
    data = DataLoader(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                 global_batch=8))
    step = make_train_step(cfg, rcfg, tcfg)
    losses = []
    for _ in range(100):
        b = {k: torch.from_numpy(v) for k, v in next(data).items()}
        params, opt, m, met = step(params, opt, m, b)
        losses.append(float(met["loss"]))
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    assert last < first - 0.5, (first, last)


def test_nonfinite_loss_writes_nothing(model):
    """A step whose loss is not finite leaves the parameters, the moments
    and the step as they were (the reference's caller drops such a step's
    pure result)."""
    _, cfg_t, _, tparams = model
    tp = tree_map(lambda t: t.clone(), tparams)
    tp["final_norm"][0] = float("nan")
    tcfg = TrainConfig()
    opt = adamw.init_opt_state(tp, tcfg)
    before = [t.clone() for t in tree_leaves(tp)]
    batch, _ = _batch("reduced")
    step = make_train_step(cfg_t, TCfg(enabled=False), tcfg)
    tp, opt, _, met = step(tp, opt, torch.zeros((1, 1)),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not np.isfinite(float(met["loss"]))
    assert int(opt.step) == 0
    for a, b in zip(tree_leaves(tp), before):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert all(torch.all(t == 0) for t in tree_leaves(opt.mu))


def test_attention_grad_past_2048_keys():
    """gqa_forward's q-blocked, chunked online softmax at 2304 keys is
    differentiable as written: its gradient matches jax.grad of the
    reference's."""
    cfg_j = jreduced(jget(ARCH), d_model=32, n_heads=2, n_kv_heads=2,
                     head_dim=16)
    cfg_t = reduced(get_config(ARCH), d_model=32, n_heads=2, n_kv_heads=2,
                    head_dim=16)
    rng = np.random.default_rng(3)
    p = {"wq": rng.normal(0, 0.2, (32, 2, 16)),
         "wk": rng.normal(0, 0.2, (32, 2, 16)),
         "wv": rng.normal(0, 0.2, (32, 2, 16)),
         "wo": rng.normal(0, 0.2, (2, 16, 32))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    s = 2304
    x = rng.normal(0, 1, (1, s, 32)).astype(np.float32)
    w = rng.normal(0, 1, (1, s, 32)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]

    def loss_j(p, x):
        o, _ = jattn.gqa_forward(p, x, cfg_j, positions=pos)
        return jnp.sum(o * w)

    gp_j, gx_j = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(p, x)
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    o, _ = tattn.gqa_forward(pt, xt, cfg_t, positions=torch.from_numpy(pos))
    (o * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(xt.grad).all()
    _compare(gx_j, xt.grad, "dx")
    for k in p:
        _compare(gp_j[k], pt[k].grad, f"d{k}")

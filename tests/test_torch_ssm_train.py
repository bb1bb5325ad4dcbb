"""Training through Mamba layers in the port against the reference on the
CPU: reduced falcon-mamba-7b (8 Mamba layers, no FFN) and reduced
jamba-1.5-large-398b (one 8-layer block: attention then 7 Mamba layers,
MoE on the odd layers), f32, the reference's weights passed through numpy
(helpers and the spread tolerance in ``_torch_arch.py``).

* ``_ssm_core`` with a carried state (the scan's step 0 folds it in, out
  of place) and one Mamba layer in "train" (falcon's, and jamba's with its
  MoE FFN): every gradient against ``jax.vjp`` at ``test_torch_train.py``'s
  layer tolerance.
* ``train_loss`` and its gradient against ``jax.value_and_grad``, each leaf
  within the reference's own spread; the ``remat`` modes ("none", "full",
  "attn_out") give bit-equal losses and gradients.
* Reduced jamba on a ``(2, 2)`` gloo mesh (FSDP, ``test_torch_train_mesh.py``'s
  recipe: aux coefficients 0, capacity factor 8, the gate closed): the
  gradient against the reference's one-device one (its criterion, 5e-3)
  and the port's (the spread); the Mamba weights whole on every rank, and
  every replicated leaf and its gradient the same bits on every rank,
  also after an AdamW step.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch as ta
from _torch_dist import run_ranks
from _torch_ep_workers import ssm_train_mesh_cases
from repro.configs import ReaLBConfig as JCfg
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim.grad_utils import value_and_grad

FALCON, JAMBA = "falcon-mamba-7b", "jamba-1.5-large-398b"
POLICY = dict(gate_gamma=8, md_init=0.0, adaptive=False)   # FP4 voted
MESH_CASE = dict(moe=dict(aux_loss_coef=0.0, router_z_coef=0.0,
                          capacity_factor=8.0),
                 rcfg=dict(gate_gamma=10 ** 9))
MOE_KEYS = ("w_gate", "w_up", "w_down")
FSDP_DIM = {"w_gate": -2, "w_up": -2, "w_down": -1}
MESH_TOL = 5e-3                      # the reference's mesh criterion


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = ta.Model(arch)
        return built[arch]
    return get


def _close(j, t, what):
    j = np.asarray(j)
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    np.testing.assert_allclose(t, j, rtol=ta.RTOL,
                               atol=ta.ATOL_REL * float(np.abs(j).max()),
                               err_msg=what)


def test_carried_state_gradient_matches_reference(models):
    """``_ssm_core`` over 12 steps from a nonzero carried conv and SSM
    state: the outputs, and the gradients of the weights, of ``xz`` and of
    both carried states, against ``jax.vjp`` of the reference's."""
    m = models(FALCON)
    p = jax.tree.map(lambda a: np.array(a[0]),
                     m.npp["blocks"]["layer0"]["ssm"])
    s_cfg = m.cfg_t.ssm
    d_in = s_cfg.expand * m.cfg_t.d_model
    rng = np.random.default_rng(4)
    xz = rng.normal(0, 1, (2, 12, 2 * d_in)).astype(np.float32)
    conv = rng.normal(0, 1, (2, s_cfg.d_conv - 1, d_in)).astype(np.float32)
    st = rng.normal(0, 1, (2, d_in, s_cfg.d_state)).astype(np.float32)
    wy = rng.normal(0, 1, (2, 12, d_in)).astype(np.float32)
    ws = rng.normal(0, 1, st.shape).astype(np.float32)

    def loss_j(p, xz, conv, st):
        y, _, h = jssm._ssm_core(p, xz, conv, st, m.cfg_j, seq_mode=True)
        return jnp.sum(y * wy) + jnp.sum(h * ws), (y, h)

    (_, (y_j, h_j)), grads_j = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2, 3), has_aux=True))(p, xz, conv, st)
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    ins = [torch.from_numpy(a).requires_grad_() for a in (xz, conv, st)]
    y_t, _, h_t = tssm._ssm_core(pt, *ins, m.cfg_t, seq_mode=True)
    ((y_t * torch.from_numpy(wy)).sum()
     + (h_t * torch.from_numpy(ws)).sum()).backward()
    _close(y_j, y_t, "y")
    _close(h_j, h_t, "final state")
    for name, gj, t in zip(("xz", "conv", "ssm"), grads_j[1:], ins):
        _close(gj, t.grad, f"d {name}")
    for k in p:
        if k in ("w_in", "w_out"):      # the projections around the core
            assert pt[k].grad is None and not np.any(grads_j[0][k])
            continue
        _close(grads_j[0][k], pt[k].grad, f"d {k}")


@pytest.mark.parametrize("arch,layer,ffn", [(FALCON, "layer0", "none"),
                                            (JAMBA, "layer1", "moe")])
def test_mamba_layer_grads_match_reference(models, arch, layer, ffn):
    """One Mamba layer in "train" (jamba's with its MoE FFN, FP4 voted and
    forced off) on one input and cotangent: the output, ``m_state``, the
    statistics, d x and every parameter's gradient."""
    m = models(arch)
    lp = jax.tree.map(lambda a: np.asarray(a[0]), m.npp["blocks"][layer])
    rng = np.random.default_rng(5)
    b, s, d = 4, 16, m.cfg_t.d_model
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    w = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    mod = rng.random((b, s)) < 0.6
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(s, dtype=np.int32)[None], (b, s)))
    mst = np.zeros((1, 4), np.float32)
    jffn = "dense" if ffn == "none" else ffn

    def loss_j(lp, x):
        out = jtf.apply_layer(lp, x, m.cfg_j, JCfg(**POLICY), "ssm", jffn,
                              mode="train", positions=pos, pos=None,
                              memory=None, cache_in=None,
                              m_state=jnp.asarray(mst), modality=mod,
                              cache_len=0, fsdp=False)
        return jnp.sum(out[0] * w) + 0.01 * out[3]["lb_loss"], out

    (_, out_j), (gl_j, gx_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, lp), jnp.asarray(x))
    tl = tree_map(lambda t: t.requires_grad_(), params_from_numpy(lp, "cpu"))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = ttf.apply_layer(tl, xt, m.cfg_t, TCfg(**POLICY), ffn,
                            mode="train", positions=torch.from_numpy(pos),
                            pos=None, cache_in=None,
                            m_state=torch.from_numpy(mst),
                            modality=torch.from_numpy(mod))
    ((out_t[0] * torch.from_numpy(w)).sum()
     + 0.01 * out_t[3]["lb_loss"]).backward()
    assert out_t[1] is None
    _close(out_j[0], out_t[0], "y")
    assert np.array_equal(np.asarray(out_j[2]), out_t[2].numpy())
    for i in (4, 5, 6):
        assert np.array_equal(np.asarray(out_j[i]), out_t[i].numpy()), i
    _close(gx_j, xt.grad, "dx")
    gj, gt = ta.flat(gl_j), ta.flat(tree_map(lambda t: t.grad, tl))
    assert set(gj) == set(gt)
    for name in gj:
        _close(gj[name], gt[name], f"grad {name}")


@pytest.mark.parametrize("arch", [FALCON, JAMBA])
def test_train_loss_and_grads_match_reference(models, arch):
    assert ta.train_grads_match(models(arch), POLICY,
                                np.random.default_rng(1)) <= 1.0


@pytest.mark.parametrize("arch", [FALCON, JAMBA])
def test_remat_policies_give_equal_grads(models, arch):
    """"none", "full" and "attn_out" give bit-equal losses, ``m_state``,
    metrics and gradients on Mamba layers, as on attention layers."""
    m = models(arch)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, m.cfg_t.vocab_size, (4, 16)).astype(np.int32)
    batch = ta.torch_batch({"tokens": tokens, "labels": tokens,
                            "modality": rng.random((4, 16)) < 0.6})
    out = {}
    for remat in ("none", "full", "attn_out"):
        cfg = dataclasses.replace(m.cfg_t, remat=remat)
        out[remat] = value_and_grad(ttf.train_loss, m.tparams, cfg,
                                    TCfg(**POLICY), batch,
                                    torch.zeros((1, 4)))
    (l0, (m0, met0)), g0 = out["none"]
    for remat in ("full", "attn_out"):
        (loss, (mst, met)), g = out[remat]
        assert torch.equal(loss, l0) and torch.equal(mst, m0), remat
        for k in met:
            assert torch.equal(met[k], met0[k]), (remat, k)
        for a, b in zip(tree_leaves(g), tree_leaves(g0)):
            assert torch.equal(a, b), remat


def _assemble(outs, shape):
    """The global gradient tree from every rank's (expert shards at their
    slots and D slices, the replicated leaves rank 0's)."""
    rows, ep = shape
    flats = [ta.flat(r["grads"]) for r in outs]
    whole = dict(flats[0])
    for name in whole:
        parent, key = name.split("/")[-2:]
        if parent != "moe" or key not in MOE_KEYS:
            continue
        by_row = [np.concatenate([flats[g * ep + m][name] for m in range(ep)],
                                 axis=1) for g in range(rows)]
        whole[name] = np.concatenate(by_row, axis=FSDP_DIM[key])
    return whole


def test_jamba_trains_on_a_2x2_mesh(models, tmp_path):
    m = models(JAMBA)
    cfg_j = dataclasses.replace(m.cfg_j, moe=dataclasses.replace(
        m.cfg_j.moe, **MESH_CASE["moe"]))
    cfg_t = dataclasses.replace(m.cfg_t, moe=dataclasses.replace(
        m.cfg_t.moe, **MESH_CASE["moe"]))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg_t.vocab_size, (4, 16)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    fn = jax.jit(jax.value_and_grad(partial(
        jtf.train_loss, cfg=cfg_j, rcfg=JCfg(**MESH_CASE["rcfg"]),
        batch=jax.tree.map(jnp.asarray, batch)), has_aux=True))
    m0 = jnp.full((1, 1), 0.9)
    (loss_j, _), g_j = fn(m.params, m_state=m0)
    g_j = ta.flat(g_j)
    g_p = [ta.flat(fn(p, m_state=m0)[1]) for p in m.perturbed()]
    (loss_t, _), g_t = value_and_grad(
        ttf.train_loss, m.tparams, cfg_t, TCfg(**MESH_CASE["rcfg"]),
        ta.torch_batch(batch), torch.full((1, 1), 0.9))
    g_t = ta.flat(g_t)

    outs = run_ranks(ssm_train_mesh_cases, (2, 2), dict(
        MESH_CASE, arch=JAMBA, params=m.npp, batch=batch), tmp_path)
    errors = [r["error"] for r in outs if "error" in r]
    assert not errors, errors[0]
    got = _assemble(outs, (2, 2))
    assert set(got) == set(g_j)
    for r in outs:
        assert abs(r["loss"] - float(loss_j)) < MESH_TOL, r["coords"]
        np.testing.assert_allclose(r["loss"], float(loss_t), rtol=ta.RTOL)
        assert r["ssm_whole"], r["coords"]
        assert r["grad_digests"] == outs[0]["grad_digests"], r["coords"]
        assert r["digests"] == outs[0]["digests"], r["coords"]
        assert r["step_loss"] == outs[0]["step_loss"]
    assert any("ssm" in k for k in outs[0]["digests"])
    worst = max(float(np.abs(got[n] - g_j[n]).max()) for n in got)
    assert worst < MESH_TOL, worst
    for name in g_t:
        ta.within_spread(g_j[name], got[name], [g[name] for g in g_p],
                         f"mesh grad {name}", tol=ta.ATOL_REL)
        ta.within_spread(g_j[name], g_t[name], [g[name] for g in g_p],
                         f"one-device grad {name}", tol=ta.ATOL_REL)

"""The port's optimizer and gradient utilities against the reference's
on the same trees, at rtol 1e-6: ``adamw_update`` over several steps (with
and without clipping), ``lr_schedule``, ``global_norm`` and
``clip_by_global_norm``, ``accumulate_grads``, ``init_error_feedback``,
``_quantize_int8`` and ``compress_leaf`` (the counterparts of
``tests/test_substrate.py``'s one-device tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrain
from repro.optim import adamw as jadamw
from repro.optim import grad_utils as jgu
from repro_torch.configs import TrainConfig
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw
from repro_torch.optim import grad_utils as tgu

# rtol 1e-6, and the same share of the tensor's largest magnitude: a
# moment is a sum of terms of either sign (b1 m + (1 - b1) g), so an
# element that cancels to near 0 keeps only the largest term's precision
RTOL = 1e-6


def _tree(rng, scale=1.0):
    return {"w": (rng.normal(0, scale, (8, 6))).astype(np.float32),
            "nest": {"b": (rng.normal(0, scale, (6,))).astype(np.float32),
                     "k": (rng.normal(0, scale, (3, 4, 5))).astype(np.float32)}}


def _close(t, j, what):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=RTOL,
                               atol=RTOL * float(np.abs(j).max()),
                               err_msg=what)


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_steps_match_reference(clip):
    """Four steps from a reference start state: parameters, moments, step,
    lr and grad norm.  Clip 0.5 clips every step; weight decay applies to
    the rank-2 and rank-3 leaves only."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=clip,
              weight_decay=0.1)
    tj, tt = JTrain(**kw), TrainConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    pj = jax.tree.map(jnp.asarray, p0)
    sj = jadamw.init_opt_state(pj, tj)
    pt = params_from_numpy(p0, "cpu")
    st = opt_state_from_numpy(jax.tree.map(np.asarray, sj), "cpu")
    for step in range(4):
        g = _tree(rng, 0.3)
        pj, sj, mj = jadamw.adamw_update(pj, jax.tree.map(jnp.asarray, g),
                                         sj, tj)
        pt, st, mt = adamw.adamw_update(
            pt, params_from_numpy(g, "cpu"), st, tt)
        _close(mt["lr"], mj["lr"], f"lr {step}")
        _close(mt["grad_norm"], mj["grad_norm"], f"grad_norm {step}")
        assert int(st.step) == int(sj.step) == step + 1
        for name, a, b in (("p", pt, pj), ("mu", st.mu, sj.mu),
                           ("nu", st.nu, sj.nu)):
            for la, lb in zip(tree_leaves(a), jax.tree.leaves(b)):
                _close(la, lb, f"{name} {step}")
    assert all(t.dtype == torch.float32 for t in tree_leaves(st.mu))


def test_adamw_moments_stay_f32_for_bf16_params():
    tt = TrainConfig()
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = adamw.init_opt_state(p, tt)
    p, st, _ = adamw.adamw_update(p, {"w": torch.full((4, 4), 0.5,
                                                      dtype=torch.bfloat16)},
                                  st, tt)
    assert p["w"].dtype == torch.bfloat16
    assert st.mu["w"].dtype == st.nu["w"].dtype == torch.float32
    assert st.step.dtype == torch.int32


def test_adamw_apply_false_writes_nothing():
    tt = TrainConfig(lr=1.0, warmup_steps=1)
    p = {"w": torch.ones((3, 3))}
    st = adamw.init_opt_state(p, tt)
    p, st, _ = adamw.adamw_update(p, {"w": torch.ones((3, 3))}, st, tt,
                                  apply=torch.tensor(False))
    assert torch.equal(p["w"], torch.ones((3, 3))) and int(st.step) == 0
    assert torch.all(st.mu["w"] == 0) and torch.all(st.nu["w"] == 0)


@pytest.mark.parametrize("cfg", [dict(lr=1.0, warmup_steps=10,
                                      total_steps=100),
                                 dict(lr=3e-4, warmup_steps=0,
                                      total_steps=7),
                                 dict(lr=1e-3, warmup_steps=20,
                                      total_steps=150)])
def test_lr_schedule_matches_reference(cfg):
    tj, tt = JTrain(**cfg), TrainConfig(**cfg)
    steps = np.arange(0, cfg["total_steps"] + 11, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: jadamw.lr_schedule(s, tj))(
        jnp.asarray(steps)))
    got = torch.stack([adamw.lr_schedule(torch.tensor(int(s),
                                                      dtype=torch.int32), tt)
                       for s in steps])
    _close(got, want, "lr")
    assert float(got[0]) == 0.0 or cfg["warmup_steps"] == 0
    assert float(got[-1]) == pytest.approx(0.1 * cfg["lr"], rel=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    """Clipped (and not), with a bf16 leaf cast back to bf16."""
    rng = np.random.default_rng(1)
    g = _tree(rng, 2.0)
    gj = jax.tree.map(jnp.asarray, g)
    gj["nest"]["b"] = gj["nest"]["b"].astype(jnp.bfloat16)
    gt = params_from_numpy(jax.tree.map(np.asarray, gj), "cpu")
    cj, nj = jadamw.clip_by_global_norm(gj, max_norm)
    ct, nt = adamw.clip_by_global_norm(gt, max_norm)
    _close(nt, nj, "norm")
    _close(adamw.global_norm(gt), jadamw.global_norm(gj), "global_norm")
    assert ct["nest"]["b"].dtype == torch.bfloat16
    for la, lb in zip(tree_leaves(ct), jax.tree.leaves(cj)):
        np.testing.assert_allclose(la.float().numpy(),
                                   np.asarray(lb, np.float32), rtol=RTOL)


def test_accumulate_grads_matches_reference():
    """Four microbatches of a small regression: mean loss, mean grads and
    the last aux, against the reference's (and the full batch's)."""
    rng = np.random.default_rng(2)
    p0 = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
          "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    xs = rng.normal(0, 1, (4, 2, 5)).astype(np.float32)
    ys = rng.normal(0, 1, (4, 2, 3)).astype(np.float32)

    def loss_j(p, batch):
        r = batch["x"] @ p["w"] + p["b"][None] - batch["y"]
        return jnp.mean(r ** 2), {"n": jnp.sum(batch["x"])}

    def loss_t(p, batch):
        r = batch["x"] @ p["w"] + p["b"] - batch["y"]
        return torch.mean(r ** 2), {"n": torch.sum(batch["x"])}

    lj, gj, aj = jgu.accumulate_grads(
        loss_j, jax.tree.map(jnp.asarray, p0),
        {"x": jnp.asarray(xs), "y": jnp.asarray(ys)}, 4)
    lt, gt, at = tgu.accumulate_grads(
        loss_t, params_from_numpy(p0, "cpu"),
        {"x": torch.from_numpy(xs), "y": torch.from_numpy(ys)}, 4)
    _close(lt, lj, "loss")
    _close(at["n"], aj["n"], "aux")
    for k in p0:
        _close(gt[k], gj[k], k)
        assert gt[k].dtype == torch.float32


def test_init_error_feedback_matches_reference():
    g = {"w": torch.ones((3, 3), dtype=torch.bfloat16),
         "n": {"b": torch.ones(4)}}
    ef = tgu.init_error_feedback(g)
    ej = jgu.init_error_feedback({"w": jnp.ones((3, 3), jnp.bfloat16),
                                  "n": {"b": jnp.ones(4)}})
    for a, b in zip(tree_leaves(ef), jax.tree.leaves(ej)):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert float(a.abs().sum()) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_leaf_matches_reference(dtype):
    """Error feedback + int8 quantization + the reduction (the identity on
    one device): the int8 codes and scale bitwise, the reduced leaf and
    the new residual at rtol 1e-6, and reduced + residual = g + err."""
    rng = np.random.default_rng(3)
    g = rng.normal(0, 1, (16, 24)).astype(np.float32)
    err = rng.normal(0, 0.01, (16, 24)).astype(np.float32)
    gj = jnp.asarray(g).astype(dtype)
    gt = params_from_numpy(np.asarray(gj), "cpu")
    qj, sj = jgu._quantize_int8(jnp.asarray(g) + jnp.asarray(err))
    qt, st = tgu._quantize_int8(torch.from_numpy(g) + torch.from_numpy(err))
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)
    rj, ej = jgu.compress_leaf(gj, jnp.asarray(err), lambda x: x)
    rt, et = tgu.compress_leaf(gt, torch.from_numpy(err), lambda x: x)
    assert rt.dtype == gt.dtype
    np.testing.assert_allclose(rt.float().numpy(), np.asarray(rj, np.float32),
                               rtol=RTOL)
    _close(et, ej, "residual")
    if dtype == "float32":
        torch.testing.assert_close(rt + et, gt + torch.from_numpy(err),
                                   rtol=1e-6, atol=1e-6)

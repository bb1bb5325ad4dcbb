"""llama-3.2-vision-90b in the port against the reference on the CPU: the
``"cross5"`` stack (four self-attention layers and one cross-attention
layer a block of 5) whose cross layers attend to the vision embeddings,
reduced (5 layers, d 128, 8 vision tokens) and in f32, the weights the
reference's passed through numpy (helpers and the spread tolerance in
``_torch_arch.py``).

* The config: every field, the kinds, the block period and structure,
  ``reduced``'s terms, and the parameter counts equal the reference's
  (its count adds a second K/V projection to a cross layer, which has
  none: 88.002 B declared against 87.667 B of leaves, in both packages).
* The init and cache layouts: the reference's key paths, shapes and
  dtypes (``xk``/``xv`` of the cross layer at the memory's length).
* ``cross_forward`` and ``cross_decode`` alone against the reference's,
  in f32 and bf16; one cross layer's training gradients, the memory's
  included.
* ``prefill_forward`` and two ``decode_forward``s against the jitted
  reference within 5e-5 of its max or its own spread; the reference's
  ``test_arch_smoke``, ``test_prefill_decode_consistency`` and
  ``test_vlm_modality_default_mask`` in the port.
* ``train_loss`` gradients within the spread, and the three ``remat``
  modes bit for bit.
* The engine (one-shot prefill) against the reference's on a 4-request
  stream with vision embeds: the same tokens, times and IterStats.
* Refusals: ``chunk_forward``, a prefill without vision embeds, and a
  request with another number of embed rows than ``n_vision_tokens``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch as ta
from repro.configs import ReaLBConfig as JCfg
from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.common import tree_map
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

ARCH = "llama-3.2-vision-90b"
POLICY = dict(gate_gamma=8, md_init=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return ta.Model(ARCH)


def test_config_is_the_reference_copy():
    cfg_t, cfg_j = get_config(ARCH), jget(ARCH)
    assert ARCH in ARCH_IDS
    for c_t, c_j in ((cfg_t, cfg_j), (reduced(cfg_t), jreduced(cfg_j))):
        assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j)
        assert c_t.layer_kinds() == c_j.layer_kinds()
        assert c_t.ffn_kinds() == c_j.ffn_kinds()
        assert c_t.scan_period == c_j.scan_period == 5
        assert c_t.full_attention_only and not c_t.is_encdec
        assert ttf.block_structure(c_t) == jtf.block_structure(c_j)
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
    small = reduced(cfg_t)
    assert (small.n_layers, small.n_vision_tokens) == (5, 8)
    assert ttf.block_structure(cfg_t) == (
        (("attn", "dense"),) * 4 + (("cross", "dense"),), 20, 0)
    # the reference's count, quirk included, against the leaves
    _, n_blocks, _ = ttf.block_structure(cfg_t)
    leaves = ta.spec_param_count(ttf.model_spec(cfg_t), n_blocks)
    assert leaves == sum(int(np.prod(x.shape)) for x in
                         jax.tree.leaves(jtf.abstract_model(cfg_j)))
    assert cfg_t.param_count() == 88_002_330_624
    assert leaves == 87_666_794_496
    # a second K/V projection in each of the 20 cross layers, less the
    # final norm, which the count leaves out
    assert cfg_t.param_count() - leaves == 20 * 2 * 8192 * 8 * 128 - 8192


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_cache_layout_match_reference(dtype):
    """The port's init and cache: the reference's key paths, shapes and
    dtypes; the cross layer has ``cross`` only and caches ``xk``/``xv``
    ``[n_blocks, B, n_vision_tokens, K, Dh]``."""
    cfg_j = jreduced(jget(ARCH), param_dtype=dtype)
    cfg_t = reduced(get_config(ARCH), param_dtype=dtype)
    ref = jax.eval_shape(lambda: jtf.init_model(cfg_j, jax.random.PRNGKey(0)))
    got = ttf.init_model(cfg_t, seed=0, device="cpu")
    assert ta.layout(got) == ta.layout(ref)
    assert set(got["blocks"]["layer4"]) == {"norm1", "cross", "norm2", "ffn"}
    ref_c = jax.eval_shape(lambda: jtf.init_cache(cfg_j, 3, 20))
    got_c = ttf.init_cache(cfg_t, 3, 20, device="cpu")
    assert ta.layout(got_c) == ta.layout(ref_c)
    assert tuple(got_c["blocks"]["layer4"]["xk"].shape) == (1, 3, 8, 4, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(model, dtype):
    """``cross_forward`` (queries of 6 rows against 8 memory rows, the
    memory cast to the activations' dtype first) and ``cross_decode``
    (one row against the cached K/V) against the reference's, jitted: f32
    within ``RTOL`` / ``ATOL_REL`` x max, bf16 within one bf16 step of the
    output's max (both round the same bf16 products, summed in f32 in
    another order)."""
    rng = np.random.default_rng(4)
    lp = jax.tree.map(lambda a: np.asarray(a[0]),
                      model.npp["blocks"]["layer4"]["cross"])
    jdt = jnp.dtype(dtype)
    x = rng.normal(0, 1, (2, 6, 128)).astype(np.float32)
    mem = rng.normal(0, 0.02, (2, 8, 128)).astype(np.float32)
    cfg_j = dataclasses.replace(model.cfg_j, param_dtype=dtype)
    cfg_t = dataclasses.replace(model.cfg_t, param_dtype=dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), lp)
    xj = jnp.asarray(x, jdt)
    fj = jax.jit(lambda p, x, m: jattn.cross_forward(p, x, m, cfg_j))
    dj = jax.jit(lambda p, x, c: jattn.cross_decode(p, x, c, cfg_j))
    oj, kvj = fj(jp, xj, jnp.asarray(mem))
    odj, _ = dj(jp, xj[:, :1], kvj)
    tdt = getattr(torch, dtype)
    tp = tree_map(lambda t: t.to(tdt), params_from_numpy(lp, "cpu"))
    xt = torch.from_numpy(x).to(tdt)
    ot, kvt = tattn.cross_forward(tp, xt, torch.from_numpy(mem), cfg_t)
    odt, cache = tattn.cross_decode(tp, xt[:, :1], kvt, cfg_t)
    assert cache is kvt and ot.dtype == tdt

    def close(j, t, what):
        j = np.asarray(jnp.asarray(j, jnp.float32))
        t = t.float().numpy()
        scale = float(np.abs(j).max())
        atol = ta.ATOL_REL * scale if dtype == "float32" else 2.0 ** -8 * scale
        np.testing.assert_allclose(t, j, rtol=ta.RTOL if dtype == "float32"
                                   else 0, atol=atol, err_msg=what)
    close(oj, ot, "cross_forward out")
    close(kvj["k"], kvt["k"], "memory k")
    close(kvj["v"], kvt["v"], "memory v")
    close(odj, odt, "cross_decode out")


def test_cross_layer_grads_match_reference(model):
    """The cross layer (norm1, cross-attention, SwiGLU FFN) in "train" on
    one input, memory and cotangent: the output, d x, d memory and every
    parameter's gradient at ``test_torch_train.py``'s layer tolerance."""
    lp = jax.tree.map(lambda a: np.asarray(a[0]), model.npp["blocks"]["layer4"])
    rng = np.random.default_rng(5)
    b, s, d = 2, 16, 128
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    mem = rng.normal(0, 0.02, (b, 8, d)).astype(np.float32)
    w = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(s, dtype=np.int32)[None], (b, s)))
    mstate = np.zeros((1, 1), np.float32)

    def loss_j(lp, x, mem):
        out = jtf.apply_layer(lp, x, model.cfg_j, JCfg(), "cross", "dense",
                              mode="train", positions=pos, pos=None,
                              memory=mem, cache_in=None,
                              m_state=jnp.asarray(mstate),
                              modality=np.zeros((b, s), bool), cache_len=0,
                              fsdp=False)
        return jnp.sum(out[0] * w), out[0]

    (_, y_j), (gl_j, gx_j, gm_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True))(
            jax.tree.map(jnp.asarray, lp), jnp.asarray(x), jnp.asarray(mem))
    tl = tree_map(lambda t: t.requires_grad_(), params_from_numpy(lp, "cpu"))
    xt = torch.from_numpy(x).requires_grad_()
    mt = torch.from_numpy(mem).requires_grad_()
    out = ttf.apply_layer(tl, xt, model.cfg_t, TCfg(), "dense", mode="train",
                          positions=torch.from_numpy(pos), pos=None,
                          cache_in=None, m_state=torch.from_numpy(mstate),
                          modality=torch.zeros((b, s), dtype=torch.bool),
                          memory=mt)
    assert out[1] is None
    (out[0] * torch.from_numpy(w)).sum().backward()

    def close(j, t, what):
        j = np.asarray(j)
        np.testing.assert_allclose(
            t.detach().numpy(), j, rtol=ta.RTOL,
            atol=ta.ATOL_REL * float(np.abs(j).max()), err_msg=what)
    close(y_j, out[0], "y")
    close(gx_j, xt.grad, "dx")
    close(gm_j, mt.grad, "d memory")
    gj, gt = ta.flat(gl_j), ta.flat(tree_map(lambda t: t.grad, tl))
    assert set(gj) == set(gt)
    for name in gj:
        close(gj[name], torch.from_numpy(gt[name]), f"grad {name}")


def test_prefill_then_decode_match_reference(model):
    res = ta.prefill_then_decode(model, dict(gate_gamma=4),
                                 np.random.default_rng(1))
    assert tuple(res.cache["blocks"]["layer4"]["xk"].shape) == (1, 3, 8, 4, 32)


def test_arch_smoke(model):
    ta.smoke(model, np.random.default_rng(0))


def test_prefill_decode_consistency(model):
    ta.consistency(model, np.random.default_rng(2))


def test_vlm_modality_default_mask():
    """The reference's test in the port: with no modality given, a VLM's
    first ``n_vision_tokens`` positions are vision outside decode; decode
    defaults to text."""
    cfg = reduced(get_config(ARCH))
    tokens = torch.zeros((2, 16), dtype=torch.int32)
    for mode in ("train", "prefill"):
        _, mod = ttf._prepare_inputs(cfg, {"tokens": tokens}, mode)
        _, ref = jtf._prepare_inputs(jreduced(jget(ARCH)),
                                     {"tokens": jnp.zeros((2, 16), jnp.int32)},
                                     mode)
        assert np.array_equal(mod.numpy(), np.asarray(ref))
        assert bool(mod[:, :cfg.n_vision_tokens].all())
        assert not bool(mod[:, cfg.n_vision_tokens:].any())
    _, mod = ttf._prepare_inputs(cfg, {"tokens": tokens[:, :1]}, "decode")
    assert not bool(mod.any())


def test_vision_embeds_overwrite_the_leading_rows(model):
    """``_embed`` writes every row of ``vision_embeds`` over the leading
    positions of every sequence (a training batch carries as many rows as
    its longest vision prefix), bitwise the reference's
    ``dynamic_update_slice``, and ignores them in decode."""
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (3, 12)).astype(np.int32)
    vis = rng.normal(0, 0.02, (3, 5, 128)).astype(np.float32)
    xj = jtf._embed(model.params, model.cfg_j, jnp.asarray(tokens),
                    jnp.asarray(vis), "train")
    xt = ttf._embed(model.tparams, model.cfg_t, torch.from_numpy(tokens),
                    torch.from_numpy(vis), "train")
    assert np.array_equal(np.asarray(xj), xt.numpy())
    xd = ttf._embed(model.tparams, model.cfg_t, torch.from_numpy(tokens),
                    torch.from_numpy(vis), "decode")
    assert np.array_equal(xd.numpy(), np.asarray(jtf._embed(
        model.params, model.cfg_j, jnp.asarray(tokens), None, "decode")))


def test_train_grads_match_reference(model):
    assert ta.train_grads_match(model, dict(gate_gamma=4),
                                np.random.default_rng(3)) <= 1.0


def test_remat_modes_give_the_same_gradients_bitwise(model):
    """``remat`` "none", "full" and "attn_out" (the cross layer recomputed
    whole under the last, as the reference names only the self-attention
    output): the same loss and gradients bit for bit."""
    from repro_torch.optim.grad_utils import value_and_grad
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 512, (2, 16)).astype(np.int32)
    batch = ta.torch_batch({"tokens": tokens, "labels": tokens,
                            **ta.memory_batch(model.cfg_t, rng, 2)})
    outs = []
    for remat in ("none", "full", "attn_out"):
        cfg = dataclasses.replace(model.cfg_t, remat=remat)
        (loss, _), g = value_and_grad(ttf.train_loss, model.tparams, cfg,
                                      TCfg(), batch, torch.zeros((1, 1)))
        outs.append((float(loss), ta.flat(g)))
    for loss, g in outs[1:]:
        assert loss == outs[0][0]
        assert all(np.array_equal(g[k], outs[0][1][k]) for k in g)


def test_engine_matches_reference(model):
    """Four requests with 8 rows of vision embeds each through both
    engines (one-shot prefill): the same tokens, times and IterStats."""
    rows = ta.memory_requests(model.cfg_t, np.random.default_rng(9), 4)
    eng, done = ta.memory_engines_agree(model, POLICY, rows)
    assert not eng.chunked and len(done) == 4
    assert tuple(eng.cache["blocks"]["layer4"]["xk"].shape) == (
        1, 4, 8, 4, 32)


def test_refusals(model):
    """``chunk_forward`` refuses the cross5 stack; a prefill without
    vision embeds raises ``ValueError`` naming them (the reference's is a
    ``KeyError``); the engine refuses a request whose embeds have another
    number of rows than ``n_vision_tokens``, naming both."""
    cfg, params = model.cfg_t, model.tparams
    tokens = torch.zeros((1, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="plain-attention"):
        ttf.chunk_forward(params, cfg, TCfg(), {
            "tokens": tokens, "start": torch.zeros(1, dtype=torch.int32),
            "chunk_len": torch.full((1,), 12, dtype=torch.int32)},
            ttf.init_cache(cfg, 1, 16, device="cpu"), torch.zeros((1, 1)))
    with pytest.raises(ValueError, match="vision_embeds"):
        ttf.prefill_forward(params, cfg, TCfg(), {"tokens": tokens},
                            torch.zeros((1, 1)))
    eng = Engine(cfg, params, TCfg(), device="cpu", **ta.ENGINE)
    for rows in (7, None):
        req = Request(uid=0, tokens=np.zeros(12, np.int32),
                      modality=np.zeros(12, bool), max_new_tokens=2,
                      vision_embeds=None if rows is None
                      else np.zeros((rows, 128), np.float32))
        with pytest.raises(ValueError, match=f"{rows} rows.* 8"):
            eng.submit(req)
    assert eng.scheduler.idle

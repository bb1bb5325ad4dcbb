"""whisper-large-v3 in the port against the reference on the CPU: the
encoder-decoder, a non-causal encoder over the frame embeddings and a
decoder whose every layer runs self-attention, then cross-attention to
the encoder's output, then a GELU MLP; QKV bias; RoPE and RMSNorm in both
stacks, as the reference builds them.  Reduced (2 encoder layers over 16
frames, 4 decoder layers, d 128) and in f32, the weights the reference's
passed through numpy (helpers and the spread tolerance in
``_torch_arch.py``).

* The config: every field, the kinds, the block structure (all "dec"),
  ``reduced``'s terms, and the parameter counts equal the reference's
  (its count takes the decoder layers as self-attention only: 1.391 B
  declared against 1.601 B of leaves, in both packages).
* The init and cache layouts: the reference's key paths, shapes and
  dtypes (``enc_blocks``, ``enc_norm``; ``norm_cross``, ``cross``;
  ``xk``/``xv`` at the encoder's length).
* ``cross_forward`` and ``cross_decode`` with QKV bias, in f32 and bf16;
  the encoder alone; the GELU MLP alone; one decoder layer's training
  gradients, the memory's included.
* ``prefill_forward`` and two ``decode_forward``s against the jitted
  reference within 5e-5 of its max or its own spread; the reference's
  ``test_arch_smoke`` and ``test_prefill_decode_consistency`` in the port.
* ``train_loss`` gradients within the spread, and the three ``remat``
  modes bit for bit.
* The engine (one-shot prefill) against the reference's on four requests
  with frame embeds and one without (the reference's zero memory): the
  same tokens, times and IterStats.
* Refusals: ``chunk_forward`` and ``Engine.chunked``, a prefill without
  ``enc_embeds``, a request with another number of frames.
* At its published widths cut to 1 + 1 layers (the card's f32 check),
  the reference is not chaotic and the port's decode/prefill gap lies
  within the reference's bound.
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
from repro.models import ffn as jffn
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import ffn as tffn
from repro_torch.models import transformer as ttf
from repro_torch.models.common import tree_map
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

ARCH = "whisper-large-v3"
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


def _close(j, t, what, rtol=ta.RTOL, atol_rel=ta.ATOL_REL):
    j = np.asarray(jnp.asarray(j, jnp.float32))
    t = t.detach().float().numpy()
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=atol_rel * float(np.abs(j).max()),
                               err_msg=what)


def _with_bias(lp, rng):
    """A layer's attention parameters with nonzero Q/K/V biases (they
    init at zero)."""
    out = dict(lp)
    for k in ("bq", "bk", "bv"):
        out[k] = rng.normal(0, 0.5, lp[k].shape).astype(np.float32)
    return out


def test_config_is_the_reference_copy():
    cfg_t, cfg_j = get_config(ARCH), jget(ARCH)
    assert ARCH in ARCH_IDS
    for c_t, c_j in ((cfg_t, cfg_j), (reduced(cfg_t), jreduced(cfg_j))):
        assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j)
        assert c_t.layer_kinds() == c_j.layer_kinds()
        assert c_t.scan_period == c_j.scan_period == 1
        assert c_t.is_encdec and c_t.full_attention_only
        assert ttf.block_structure(c_t) == jtf.block_structure(c_j)
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
    small = reduced(cfg_t)
    assert (small.n_layers, small.n_enc_layers, small.enc_seq_len) == (
        4, 2, 16)
    assert ttf.block_structure(cfg_t) == ((("dec", "dense"),), 32, 0)
    assert cfg_t.param_count() == 1_391_232_000
    leaves = sum(int(np.prod(x.shape)) for x in
                 jax.tree.leaves(jtf.abstract_model(cfg_j)))
    assert leaves == 1_601_359_360
    spec = ttf.model_spec(cfg_t)
    assert leaves == ta.spec_param_count(
        {k: v for k, v in spec.items() if k != "enc_blocks"}, 32) \
        + ta.spec_param_count({"blocks": spec["enc_blocks"]}, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_cache_layout_match_reference(dtype):
    """The port's init and cache: the reference's key paths, shapes and
    dtypes; the encoder stacked ``n_enc_layers`` deep, each decoder layer
    with ``attn``, ``norm_cross`` and ``cross``, its cache ``k``/``v``
    beside ``xk``/``xv [n_blocks, B, enc_seq_len, K, Dh]``."""
    cfg_j = jreduced(jget(ARCH), param_dtype=dtype)
    cfg_t = reduced(get_config(ARCH), param_dtype=dtype)
    ref = jax.eval_shape(lambda: jtf.init_model(cfg_j, jax.random.PRNGKey(0)))
    got = ttf.init_model(cfg_t, seed=0, device="cpu")
    assert ta.layout(got) == ta.layout(ref)
    assert set(got["blocks"]["layer0"]) == {"norm1", "attn", "norm_cross",
                                            "cross", "norm2", "ffn"}
    assert tuple(got["enc_blocks"]["layer0"]["attn"]["wq"].shape) == (
        2, 128, 4, 32)
    ref_c = jax.eval_shape(lambda: jtf.init_cache(cfg_j, 3, 20))
    got_c = ttf.init_cache(cfg_t, 3, 20, device="cpu")
    assert ta.layout(got_c) == ta.layout(ref_c)
    assert tuple(got_c["blocks"]["layer0"]["xk"].shape) == (4, 3, 16, 4, 32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_with_bias_matches_reference(model, dtype):
    """``cross_forward`` (6 query rows against 16 frames) and
    ``cross_decode`` with nonzero Q/K/V biases against the reference's,
    jitted: f32 at the layer tolerance, bf16 within one bf16 step of the
    output's max."""
    rng = np.random.default_rng(4)
    lp = _with_bias(jax.tree.map(lambda a: np.asarray(a[0]),
                                 model.npp["blocks"]["layer0"]["cross"]), rng)
    x = rng.normal(0, 1, (2, 6, 128)).astype(np.float32)
    mem = rng.normal(0, 1, (2, 16, 128)).astype(np.float32)
    cfg_j = dataclasses.replace(model.cfg_j, param_dtype=dtype)
    cfg_t = dataclasses.replace(model.cfg_t, param_dtype=dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), lp)
    xj = jnp.asarray(x, jdt)
    oj, kvj = jax.jit(lambda p, x, m: jattn.cross_forward(p, x, m, cfg_j))(
        jp, xj, jnp.asarray(mem))
    odj, _ = jax.jit(lambda p, x, c: jattn.cross_decode(p, x, c, cfg_j))(
        jp, xj[:, :1], kvj)
    tp = tree_map(lambda t: t.to(tdt), params_from_numpy(lp, "cpu"))
    xt = torch.from_numpy(x).to(tdt)
    ot, kvt = tattn.cross_forward(tp, xt, torch.from_numpy(mem), cfg_t)
    odt, _ = tattn.cross_decode(tp, xt[:, :1], kvt, cfg_t)
    tol = dict(rtol=ta.RTOL, atol_rel=ta.ATOL_REL) if dtype == "float32" \
        else dict(rtol=0, atol_rel=2.0 ** -8)
    _close(oj, ot, "cross_forward out", **tol)
    _close(kvj["k"], kvt["k"], "memory k", **tol)
    _close(kvj["v"], kvt["v"], "memory v", **tol)
    _close(odj, odt, "cross_decode out", **tol)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_encoder_matches_reference(model, remat):
    """``_encode`` (two non-causal layers over 16 frames, then
    ``enc_norm``) against the reference's jitted one; under
    ``remat="full"`` the port checkpoints each layer in training, with
    the same values."""
    rng = np.random.default_rng(6)
    frames = rng.normal(0, 1, (2, 16, 128)).astype(np.float32)
    cfg_j = dataclasses.replace(model.cfg_j, remat=remat)
    cfg_t = dataclasses.replace(model.cfg_t, remat=remat)
    m = np.zeros((1, 1), np.float32)
    ej = jax.jit(lambda p, f: jtf._encode(p, cfg_j, f, JCfg(),
                                          jnp.asarray(m)))(
        model.params, jnp.asarray(frames))
    et = ttf._encode(model.tparams, cfg_t, TCfg(), torch.from_numpy(frames),
                     torch.from_numpy(m), train=True)
    _close(ej, et, "encoder output")


def test_gelu_mlp_matches_reference(model):
    """The plain GELU MLP (tanh-approximate, JAX's default) of a decoder
    layer against the reference's ``ffn_forward``."""
    rng = np.random.default_rng(10)
    lp = jax.tree.map(lambda a: np.asarray(a[0]),
                      model.npp["blocks"]["layer0"]["ffn"])
    assert set(lp) == {"w_up", "w_down"}
    x = rng.normal(0, 1, (2, 8, 128)).astype(np.float32)
    yj = jffn.ffn_forward(jax.tree.map(jnp.asarray, lp), jnp.asarray(x),
                          model.cfg_j)
    yt = tffn.ffn_forward(params_from_numpy(lp, "cpu"), torch.from_numpy(x),
                          model.cfg_t)
    _close(yj, yt, "gelu mlp")


def test_decoder_layer_grads_match_reference(model):
    """One "dec" layer (self-attention, cross-attention after
    ``norm_cross``, GELU MLP; nonzero biases) in "train" on one input,
    memory and cotangent: the output, d x, d memory and every parameter's
    gradient at ``test_torch_train.py``'s layer tolerance (the cross
    key bias's, zero but for rounding, under it)."""
    rng = np.random.default_rng(5)
    lp = jax.tree.map(lambda a: np.asarray(a[0]),
                      model.npp["blocks"]["layer0"])
    lp = dict(lp, attn=_with_bias(lp["attn"], rng),
              cross=_with_bias(lp["cross"], rng))
    b, s, d = 2, 12, 128
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    mem = rng.normal(0, 1, (b, 16, d)).astype(np.float32)
    w = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(s, dtype=np.int32)[None], (b, s)))
    mstate = np.zeros((1, 1), np.float32)

    def loss_j(lp, x, mem):
        out = jtf.apply_layer(lp, x, model.cfg_j, JCfg(), "dec", "dense",
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
    (out[0] * torch.from_numpy(w)).sum().backward()
    _close(y_j, out[0], "y")
    _close(gx_j, xt.grad, "dx")
    _close(gm_j, mt.grad, "d memory")
    gj, gt = ta.flat(gl_j), ta.flat(tree_map(lambda t: t.grad, tl))
    assert set(gj) == set(gt)
    for name in gj:
        if name == "/cross/bk":
            # zero in exact arithmetic (with no RoPE a key bias adds q . b_k
            # to every score of a query, which softmax ignores): both are
            # rounding noise, held under the layer tolerance of the query
            # bias's gradient
            bound = ta.ATOL_REL * float(np.abs(gj["/cross/bq"]).max())
            assert np.abs(gj[name]).max() <= bound
            assert np.abs(gt[name]).max() <= bound
            continue
        _close(gj[name], torch.from_numpy(gt[name]), f"grad {name}")


def test_prefill_then_decode_match_reference(model):
    res = ta.prefill_then_decode(model, dict(gate_gamma=4),
                                 np.random.default_rng(1))
    assert tuple(res.cache["blocks"]["layer0"]["xk"].shape) == (
        4, 3, 16, 4, 32)


def test_arch_smoke(model):
    ta.smoke(model, np.random.default_rng(0))


def test_prefill_decode_consistency(model):
    ta.consistency(model, np.random.default_rng(2))


def test_train_grads_match_reference(model):
    assert ta.train_grads_match(model, dict(gate_gamma=4),
                                np.random.default_rng(3)) <= 1.0


def test_remat_modes_give_the_same_gradients_bitwise(model):
    """``remat`` "none", "full" (each encoder layer and each decoder block
    checkpointed) and "attn_out" (each decoder layer's self-attention
    output saved, its cross-attention recomputed): the same loss and
    gradients bit for bit."""
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


def test_engine_matches_reference_with_a_zero_memory_request(model):
    """Four requests with 16 frame embeds each and one with none (the
    reference's zero memory) through both engines, one-shot prefill: the
    same tokens, times and IterStats."""
    rows = ta.memory_requests(model.cfg_t, np.random.default_rng(9), 5,
                              without=(2,))
    assert rows[2][4] is None and rows[0][4].shape == (16, 128)
    eng, done = ta.memory_engines_agree(model, POLICY, rows)
    assert len(done) == 5 and not eng.chunked


def test_refusals(model):
    """``chunk_forward`` refuses the encoder-decoder and ``Engine.chunked``
    is False, as in the reference; a prefill without ``enc_embeds`` raises
    ``ValueError`` naming them; the engine refuses a request whose frames
    are not ``enc_seq_len`` rows, naming both numbers."""
    cfg, params = model.cfg_t, model.tparams
    tokens = torch.zeros((1, 12), dtype=torch.int32)
    with pytest.raises(ValueError, match="plain-attention"):
        ttf.chunk_forward(params, cfg, TCfg(), {
            "tokens": tokens, "start": torch.zeros(1, dtype=torch.int32),
            "chunk_len": torch.full((1,), 12, dtype=torch.int32)},
            ttf.init_cache(cfg, 1, 16, device="cpu"), torch.zeros((1, 1)))
    with pytest.raises(ValueError, match="enc_embeds"):
        ttf.prefill_forward(params, cfg, TCfg(), {"tokens": tokens},
                            torch.zeros((1, 1)))
    eng = Engine(cfg, params, TCfg(), device="cpu", **ta.ENGINE)
    assert eng.chunked is False
    req = Request(uid=0, tokens=np.zeros(12, np.int32),
                  modality=np.zeros(12, bool), max_new_tokens=2,
                  vision_embeds=np.zeros((15, 128), np.float32))
    with pytest.raises(ValueError, match="15 rows.* 16"):
        eng.submit(req)
    assert eng.scheduler.idle


def test_card_consistency_depth_is_not_chaotic():
    """whisper-large-v3 at its published widths cut to the first encoder
    and decoder layer, where ``chip_smoke.consistency_f32`` holds the f32
    decode/prefill gap (1500 frames, vocab cut to 8192): the reference's
    own spread under two ulps of its embedding and frames stays under a
    tenth of its bound, and the port's gap within the bound.  (At 2 + 2
    layers the spread is 2.27 of the bound on this CPU: chaotic.)"""
    spread, gap = ta.card_check_is_not_chaotic(
        ARCH, 1, np.random.default_rng(16), n_enc_layers=1)
    assert spread <= 0.1 and gap <= 1.0

"""The three dense configs of the port against the reference on the CPU:
gemma-7b (GeGLU, tied embeddings, logit softcap 30, sqrt(d) embedding
scale, head_dim 256), qwen1.5-0.5b (QKV bias, tied) and command-r-35b
(GQA 64/8, rope_theta 8e6, tied), reduced and in f32, the weights the
reference's passed through numpy (helpers and the spread tolerance in
``_torch_arch.py``).

* The configs: every field and the parameter counts equal the
  reference's; the count of ``model_spec`` within 3 % of the declared one
  (``tests/test_models_smoke.py::test_param_counts_match_declared``).
* ``prefill_forward`` and two ``decode_forward``s against the jitted
  reference: logits and KV within 5e-5 of the reference's max or the
  reference's own spread (qwen's random model moves its logits by 6.7e-5
  of their max under two f32 ulps of its embedding).
* ``train_loss`` and its gradient on reduced gemma against
  ``jax.value_and_grad``, within the spread; one layer at the plain
  tolerance.
* The reference's ``test_arch_smoke`` and
  ``test_prefill_decode_consistency`` in the port.
* Reduced qwen's ``Engine`` (chunked prefill) against the reference's on
  a 5-request MMMU stream of <= 16-token prompts: the same tokens, times
  and IterStats; these stacks keep ``m_state`` and the statistics as the
  reference does with no MoE layer.
* qwen at its published widths (8 layers): the reference's own spread
  exceeds its consistency bound, and the port lies within the spread; cut
  to the 2 layers where the card checks it, the spread is far inside the
  bound and the port's decode/prefill gap within it.
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
from repro.models import transformer as jtf
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs import ReaLBConfig as TCfg
from repro_torch.convert import params_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.models.common import tree_map

ARCHS = ("gemma-7b", "qwen1.5-0.5b", "command-r-35b")


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


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_copy(arch):
    cfg_t, cfg_j = get_config(arch), jget(arch)
    assert arch in ARCH_IDS
    ft = dataclasses.asdict(cfg_t)
    fj = dataclasses.asdict(cfg_j)
    for k, v in ft.items():
        assert fj[k] == v, k
    assert cfg_t.mla is None and cfg_t.moe is None and cfg_t.ssm is None
    assert cfg_t.param_count() == cfg_j.param_count()
    assert cfg_t.active_param_count() == cfg_j.active_param_count()
    assert cfg_t.layer_kinds() == cfg_j.layer_kinds()
    assert cfg_t.ffn_kinds() == cfg_j.ffn_kinds()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_declared(arch):
    """``model_spec``'s count is the reference's ``abstract_model``'s,
    within 3 % of ``param_count()`` (norms are not declared)."""
    cfg = get_config(arch)
    _, n_blocks, _ = ttf.block_structure(cfg)
    got = ta.spec_param_count(ttf.model_spec(cfg), n_blocks)
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(jtf.abstract_model(jget(arch))))
    assert got == want
    assert abs(got - cfg.param_count()) / cfg.param_count() < 0.03


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_reference(models, arch):
    ta.prefill_then_decode(models(arch), dict(gate_gamma=4),
                           np.random.default_rng(1))


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_smoke(models, arch):
    ta.smoke(models(arch), np.random.default_rng(0))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_consistency(models, arch):
    ta.consistency(models(arch), np.random.default_rng(2))


def test_gemma_train_grads_match_reference(models):
    """Reduced gemma (softcap 30, tied embeddings, sqrt(d) scale, GeGLU):
    the loss and every gradient leaf within the spread."""
    assert ta.train_grads_match(models("gemma-7b"), dict(gate_gamma=4),
                                np.random.default_rng(3)) <= 1.0


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen1.5-0.5b"])
def test_layer_grads_match_reference(models, arch):
    """One attention + dense FFN layer in "train" (GeGLU; QKV bias, set
    nonzero) on one input and cotangent: the output, d x and every
    parameter's gradient at ``test_torch_train.py``'s layer tolerance."""
    m = models(arch)
    lp = jax.tree.map(lambda a: np.asarray(a[0]), m.npp["blocks"]["layer0"])
    rng = np.random.default_rng(5)
    if "bq" in lp["attn"]:
        for k in ("bq", "bk", "bv"):
            lp["attn"][k] = rng.normal(0, 0.5, lp["attn"][k].shape).astype(
                np.float32)
    b, s, d = 2, 16, m.cfg_t.d_model
    x = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    w = rng.normal(0, 1, (b, s, d)).astype(np.float32)
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(s, dtype=np.int32)[None], (b, s)))
    mstate = np.zeros((1, 1), np.float32)

    def loss_j(lp, x):
        out = jtf.apply_layer(lp, x, m.cfg_j, JCfg(), "attn", "dense",
                              mode="train", positions=pos, pos=None,
                              memory=None, cache_in=None,
                              m_state=jnp.asarray(mstate),
                              modality=np.zeros((b, s), bool), cache_len=0,
                              fsdp=False)
        return jnp.sum(out[0] * w), out[0]

    (_, y_j), (gl_j, gx_j) = jax.jit(jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True))(
            jax.tree.map(jnp.asarray, lp), jnp.asarray(x))
    tl = tree_map(lambda t: t.requires_grad_(), params_from_numpy(lp, "cpu"))
    xt = torch.from_numpy(x).requires_grad_()
    out = ttf.apply_layer(tl, xt, m.cfg_t, TCfg(), "dense", mode="train",
                          positions=torch.from_numpy(pos), pos=None,
                          cache_in=None, m_state=torch.from_numpy(mstate),
                          modality=torch.zeros((b, s), dtype=torch.bool))
    (out[0] * torch.from_numpy(w)).sum().backward()

    def close(j, t, what):
        j = np.asarray(j)
        np.testing.assert_allclose(
            t.detach().numpy(), j, rtol=ta.RTOL,
            atol=ta.ATOL_REL * float(np.abs(j).max()), err_msg=what)
    close(y_j, out[0], "y")
    close(gx_j, xt.grad, "dx")
    gj, gt = ta.flat(gl_j), ta.flat(tree_map(lambda t: t.grad, tl))
    assert set(gj) == set(gt)
    for name in gj:
        close(gj[name], torch.from_numpy(gt[name]), f"grad {name}")


def test_gemma_embedding_scale_and_softcap_round_as_reference(models):
    """The sqrt(d) scale multiplies in the parameter dtype (bf16 here, as
    the reference's ``jnp.asarray(sqrt(d), dtype)``): the embedding
    bitwise against the reference's ``_embed`` on a bf16 copy; the
    softcap's tanh runs on the f32 logits: within 2e-6 of max of the
    reference's ``_unembed``."""
    m = models("gemma-7b")
    cfg_j = dataclasses.replace(m.cfg_j, param_dtype="bfloat16")
    cfg_t = dataclasses.replace(m.cfg_t, param_dtype="bfloat16")
    tokens = np.random.default_rng(6).integers(0, cfg_j.vocab_size, (2, 7))
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), m.params)
    xj = jtf._embed(p16, cfg_j, jnp.asarray(tokens), None, "prefill")
    pt = params_from_numpy(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), p16), "cpu")
    pt = tree_map(lambda t: t.to(torch.bfloat16), pt)
    xt = ttf._embed(pt, cfg_t, torch.from_numpy(tokens))
    assert np.array_equal(np.asarray(xj.astype(jnp.float32)),
                          xt.float().numpy())
    lj = jtf._unembed(p16, cfg_j, xj)
    lt = ttf._unembed(pt, cfg_t, xt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0,
                               atol=2e-6 * float(np.abs(lj).max()))
    assert float(np.abs(np.asarray(lj)).max()) < 30.0


def test_qwen_engine_matches_reference(models):
    """Reduced qwen1.5-0.5b served chunked by both engines: the same
    tokens, times and IterStats; no MoE layer, so no FP4 and no gate."""
    eng = ta.engines_agree(models("qwen1.5-0.5b"),
                           dict(gate_gamma=8, md_init=0.0))
    assert eng.chunked
    assert all(s.fp4_ranks == 0 for s in eng.stats)


def test_published_widths_are_chaotic_in_the_reference():
    """qwen1.5-0.5b at its published widths (d 1024, 16 heads of 64, d_ff
    2816; 8 of 24 layers, vocab cut to 8192, f32): the reference's own
    prefill logits move by more than its consistency bound (2e-3 + 2e-3 x
    |logit|) when its embedding moves by two f32 ulps (its fan-in init
    over the head axis gives q and k entries ~8 and near one-hot
    softmaxes), so the card checks the f32 decode/prefill gap on the
    first 2 layers only (``chip_smoke.consistency_f32``, below); the
    port's prefill lies within ``SPREAD`` x the spread of the
    reference's."""
    m = ta.Model("qwen1.5-0.5b", **{
        k: getattr(jget("qwen1.5-0.5b"), k)
        for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff")},
        n_layers=8, vocab_size=8192)
    assert m.cfg_t.d_model == 1024 and m.cfg_t.head_dim == 64
    tokens = np.random.default_rng(0).integers(0, 8192, (2, 33)).astype(
        np.int32)
    pre = jax.jit(lambda p: jtf.prefill_forward(
        p, m.cfg_j, JCfg(), {"tokens": jnp.asarray(tokens)},
        jnp.zeros((1, 1)), cache_len=33).logits)
    ref = np.asarray(pre(m.params))
    moved = [np.asarray(pre(p)) for p in m.perturbed()]
    bound = 2e-3 + 2e-3 * np.abs(ref)
    assert any(np.any(np.abs(r - ref) > bound) for r in moved)
    got = ttf.prefill_forward(m.tparams, m.cfg_t, TCfg(),
                              {"tokens": torch.from_numpy(tokens)},
                              torch.zeros((1, 1)), cache_len=33).logits
    ta.within_spread(ref, got, moved, "prefill logits at published widths")


def test_card_consistency_depth_is_not_chaotic():
    """qwen1.5-0.5b at its published widths cut to the 2 layers on which
    ``chip_smoke.consistency_f32`` holds the f32 decode/prefill gap (vocab
    cut to 8192): the reference's own spread stays under a tenth of its
    bound, and the port's gap within the bound.  (gemma-7b's 2 layers,
    2.2 GB in f32, are measured on the card only.)"""
    ta.card_check_is_not_chaotic("qwen1.5-0.5b", 2,
                                 np.random.default_rng(16))

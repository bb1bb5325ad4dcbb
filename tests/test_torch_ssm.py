"""The port's Mamba-1 layer (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the CPU, and the config copies of the
four ported architectures against the reference's.

The scan is held bit for bit: the port copies the recursion of
``jax.lax.associative_scan``.  Called as it is (each op its own
computation) the reference's scan gives the port's bits; under ``jax.jit``
XLA's CPU backend contracts the combine's ``a2 * b1 + b2`` into one fused
multiply-add, and the port's recursion with an FMA combine gives those
bits too.  The layer is held within 1e-5 of the reference's largest value
in f32 (XLA's and torch's exp, log1p and matmul sums differ by ulps), and
in bf16 within two bf16 steps of the jitted reference's and 1e-6 of the
op-by-op reference's, whose roundings are the port's."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import ssm as jssm
from repro.models.common import init_params
from repro.models import transformer as jtf
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_numpy, to_numpy
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

ARCHS = ("moonshot-v1-16b-a3b", "olmoe-1b-7b", "falcon-mamba-7b",
         "jamba-1.5-large-398b")
F32_TOL = 1e-5           # of max |reference|
BF16_TOL = 2 * 2.0 ** -7  # two bf16 steps at the largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcombine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _fma_combine(e1, e2):
    """The combine with ``a2 * b1 + b2`` rounded once, as a fused
    multiply-add rounds it: the f32 product is exact in f64, and the f64
    sum rounds to the f32 FMA's value for these magnitudes."""
    a1, b1 = e1
    a2, b2 = e2
    return [a1 * a2, (a2.double() * b1.double() + b2.double()).float()]


def _scan_inputs(s, seed):
    rng = np.random.default_rng(seed)
    da = rng.uniform(0.3, 1.0, (2, s, 6, 4)).astype(np.float32)
    dbx = rng.standard_normal((2, s, 6, 4)).astype(np.float32)
    return da, dbx


@pytest.mark.parametrize("s", [1, 2, 3, 7, 16, 37, 64])
def test_scan_bitwise_against_associative_scan(s):
    da, dbx = _scan_inputs(s, s)
    ta, tb = torch.from_numpy(da), torch.from_numpy(dbx)
    ja, jb = jax.lax.associative_scan(
        _jcombine, (jnp.asarray(da), jnp.asarray(dbx)), axis=1)
    pa, pb = tssm.associative_scan(tssm._combine, [ta, tb], axis=1)
    assert np.array_equal(np.asarray(ja), pa.numpy())
    assert np.array_equal(np.asarray(jb), pb.numpy())
    # jitted: XLA fuses the combine's multiply-add, and so does the copy
    _, jjb = jax.jit(lambda a, b: jax.lax.associative_scan(
        _jcombine, (a, b), axis=1))(da, dbx)
    _, fb = tssm.associative_scan(_fma_combine, [ta, tb], axis=1)
    assert np.array_equal(np.asarray(jjb), fb.numpy())


def test_scan_is_not_a_sequential_loop():
    """What the recursion buys: a sequential loop sums in another order."""
    da, dbx = _scan_inputs(37, 5)
    _, h = tssm.associative_scan(tssm._combine, [torch.from_numpy(da),
                                                 torch.from_numpy(dbx)], 1)
    seq, acc = [], torch.zeros_like(torch.from_numpy(dbx[:, 0]))
    for t in range(37):
        acc = torch.from_numpy(da[:, t]) * acc + torch.from_numpy(dbx[:, t])
        seq.append(acc)
    seq = torch.stack(seq, 1)
    np.testing.assert_allclose(h.numpy(), seq.numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.equal(h, seq)


def _layer(arch, dtype):
    cfg_j = jreduced(jget(arch), param_dtype=dtype)
    cfg_t = reduced(get_config(arch), param_dtype=dtype)
    spec = jtf.layer_spec(cfg_j, "ssm", "none")["ssm"]
    p_j = init_params(spec, jax.random.PRNGKey(3), dtype)
    rng = np.random.default_rng(0)
    # perturb the ones-initialised leaves so every term is exercised
    p_j = dict(p_j)
    d_in = p_j["b_dt"].shape[0]
    p_j["b_dt"] = jnp.asarray(rng.normal(-1.0, 0.5, d_in), jnp.float32)
    p_j["a_log"] = jnp.asarray(rng.normal(0.0, 0.7, p_j["a_log"].shape),
                               jnp.float32)
    p_j["d_skip"] = jnp.asarray(rng.normal(1.0, 0.3, d_in), jnp.float32)
    p_j["conv_b"] = jnp.asarray(rng.normal(0, 0.1, d_in), dtype)
    p_t = params_from_numpy(jax.tree.map(np.asarray, p_j), "cpu")
    return cfg_j, cfg_t, p_j, p_t


def _close(t, j, tol, what):
    j = np.asarray(j).astype(np.float32)
    err = np.abs(to_numpy(t) - j).max()
    bound = tol * float(np.abs(j).max())
    assert err <= bound, (what, err, bound)
    return err / float(np.abs(j).max())


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_and_decode_match_reference(arch, dtype):
    cfg_j, cfg_t, p_j, p_t = _layer(arch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    rng = np.random.default_rng(1)
    b, s, d = 2, 13, cfg_j.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))

    out_j, st_j = jax.jit(partial(jssm.ssm_forward, cfg=cfg_j))(p_j, xj)
    out_t, st_t = tssm.ssm_forward(p_t, xt, cfg_t)
    assert out_t.dtype == xt.dtype and st_t["conv"].dtype == xt.dtype
    assert st_t["ssm"].dtype == torch.float32
    _close(out_t, out_j, tol, "forward out")
    _close(st_t["conv"], st_j["conv"], tol, "forward conv state")
    _close(st_t["ssm"], st_j["ssm"], tol, "forward ssm state")

    # three decode steps from the prefill's states
    dec = jax.jit(partial(jssm.ssm_decode, cfg=cfg_j))
    for step in range(3):
        x1 = rng.standard_normal((b, 1, d)).astype(np.float32)
        out_j, st_j = dec(p_j, jnp.asarray(x1, dtype), st_j)
        out_t, st_t = tssm.ssm_decode(
            p_t, torch.from_numpy(x1).to(xt.dtype), st_t, cfg_t)
        _close(out_t, out_j, tol, f"decode {step} out")
        _close(st_t["conv"], st_j["conv"], tol, f"decode {step} conv")
        _close(st_t["ssm"], st_j["ssm"], tol, f"decode {step} ssm")


def test_bf16_roundings_sit_where_the_reference_puts_them():
    """Where the bf16 roundings fall.  Run op by op (each op its own
    computation, rounding its result to bf16), the reference gives the
    port's layer to within 1e-6 of its largest value; the same layer with
    the conv and the projections' products kept in f32 differs from it by
    thousands of times more.  Jitted, XLA fuses elementwise chains and
    rounds fewer intermediates, which the bf16 bound of the test above
    covers."""
    cfg_j, cfg_t, p_j, p_t = _layer("jamba-1.5-large-398b", "bfloat16")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, cfg_j.d_model)).astype(np.float32)
    out_j, _ = jssm.ssm_forward(p_j, jnp.asarray(x, jnp.bfloat16), cfg_j)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    err = _close(tssm.ssm_forward(p_t, xt, cfg_t)[0], out_j, 1e-6,
                 "bf16 out, op by op")
    p_f = {k: v.float() for k, v in p_t.items()}
    cfg_f = dataclasses.replace(cfg_t, param_dtype="float32")
    out_f = tssm.ssm_forward(p_f, xt.float(), cfg_f)[0]
    ref = np.asarray(out_j).astype(np.float32)
    err_f = np.abs(out_f.numpy() - ref).max() / np.abs(ref).max()
    assert err_f > 1e-3 and err < err_f / 1000, (err, err_f)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_config_copies_match_reference(arch, full):
    cj, ct = jget(arch), get_config(arch)
    if not full:
        cj, ct = jreduced(cj), reduced(ct)
    for f in dataclasses.fields(ct):
        a, b = getattr(ct, f.name), getattr(cj, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert ct.param_count() == cj.param_count()
    assert ct.active_param_count() == cj.active_param_count()
    assert ct.scan_period == cj.scan_period
    assert ct.layer_kinds() == cj.layer_kinds()
    assert ct.ffn_kinds() == cj.ffn_kinds()
    assert ct.moe_block_structure() == cj.moe_block_structure()
    assert ct.uses_attention == cj.uses_attention
    assert ttf.block_structure(ct) == jtf.block_structure(cj)


def test_cross5_is_accepted_with_the_reference_kinds():
    """``"cross5"`` (four self-attention and one cross-attention layer a
    block of 5) is a pattern of the port: its kinds, block period and
    block structure are the reference's."""
    ct = dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                             layer_pattern="cross5", n_layers=10)
    cj = dataclasses.replace(jreduced(jget("olmoe-1b-7b")),
                             layer_pattern="cross5", n_layers=10)
    assert ct.layer_kinds() == cj.layer_kinds()
    assert ct.layer_kinds()[4] == ct.layer_kinds()[9] == "cross"
    assert ct.scan_period == cj.scan_period == 5
    assert ttf.block_structure(ct) == jtf.block_structure(cj)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_init_and_cache_layout_match_reference(arch):
    """The port's init and cache: the reference's key paths, shapes and
    dtypes (the SSM leaves' f32 override, the ones init)."""
    cfg_j, cfg_t = jreduced(jget(arch)), reduced(get_config(arch))
    ref = jax.eval_shape(lambda: jtf.init_model(cfg_j, jax.random.PRNGKey(0)))
    got = ttf.init_model(cfg_t, seed=0, device="cpu")
    ref_c = jax.eval_shape(lambda: jtf.init_cache(cfg_j, 3, 20))
    got_c = ttf.init_cache(cfg_t, 3, 20, device="cpu")

    def walk(r, a, path=""):
        if isinstance(r, dict):
            assert set(r) == set(a), path
            for k in r:
                walk(r[k], a[k], f"{path}/{k}")
            return
        assert tuple(a.shape) == tuple(r.shape), path
        assert str(a.dtype).split(".")[-1] == str(r.dtype), path
    walk(ref, got)
    walk(ref_c, got_c)
    ssm = got["blocks"][f"layer{cfg_t.scan_period - 1}"]["ssm"]
    for k in ("b_dt", "a_log", "d_skip"):
        assert torch.all(ssm[k] == 1), k


def test_mamba_stack_refuses_training_and_chunks():
    """A Mamba stack refuses chunked prefill (no SSM state threading);
    training, refused until SSM training was ported, now runs
    (``test_torch_ssm_train.py`` holds its gradients)."""
    cfg = reduced(get_config("falcon-mamba-7b"))
    params = ttf.init_model(cfg, seed=0, device="cpu")
    from repro_torch.configs import ReaLBConfig
    from repro_torch.core.policy import init_m_state
    m = init_m_state(1, 1, ReaLBConfig())
    toks = torch.zeros((1, 8), dtype=torch.int32)
    res = ttf.train_forward(params, cfg, ReaLBConfig(), {"tokens": toks}, m)
    assert res.logits.shape == (1, 8, cfg.vocab_size)
    assert torch.isfinite(res.logits).all()
    with pytest.raises(ValueError, match="plain-attention"):
        ttf.chunk_forward(params, cfg, ReaLBConfig(), {
            "tokens": toks, "start": torch.zeros(1, dtype=torch.int32),
            "chunk_len": torch.full((1,), 8, dtype=torch.int32)},
            ttf.init_cache(cfg, 1, 16, "cpu"), m)

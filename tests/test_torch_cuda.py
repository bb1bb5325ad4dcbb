"""The port on a CUDA card: each kernel against its plain version, the
reduced model through the kernels against the same model on the CPU, and
its forwards free of device-to-host syncs.

Every test here needs a card and skips without one.  The file imports no
JAX, so the card's machine runs it as it is:
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py``.
"""
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import ReaLBConfig, get_config, reduced
from repro_torch.core import quant
from repro_torch.kernels import _build
from repro_torch.kernels import fp4_matmul as mm
from repro_torch.kernels import grouped_fp4_ffn as ffn
from repro_torch.kernels import ops
from repro_torch.kernels import quantize_fp4 as qk
from repro_torch.kernels.nvfp4 import (FP4_MIDPOINTS, INV_FP4_MAX,
                                       fake_quant_a4)
from repro_torch.models import common
from repro_torch.models import transformer as tf

pytestmark = pytest.mark.gpu

# the reference's GROUPED_CASES (tests/test_kernels.py) plus one wider case
GROUPED_CASES = [
    (24, 64, 64, [3, 0, 5, 0, 0, 9, 7, 0, 0]),
    (16, 64, 96, [0, 16, 0, 0, 0]),
    (40, 128, 64, [40, 0, 0]),
    (37, 64, 64, [10, 0, 12, 15]),
    (32, 64, 64, [6, 10, 0, 16]),
    (8, 32, 32, [1, 2, 0, 5]),
    (300, 256, 192, [70, 0, 1, 64, 65, 0, 0, 40, 60]),
]
# the reference's fp4_matmul SHAPES and ODD_SHAPES (tests/test_kernels.py)
# plus the expert projection of moonshot at a short token count
MATMUL_SHAPES = [(128, 256, 512), (64, 128, 128), (256, 384, 1024),
                 (8, 128, 64), (37, 130, 96), (5, 17, 64), (100, 200, 544),
                 (1, 1, 32), (300, 1408, 2048)]


@pytest.fixture
def cuda():
    """Skips unless a card is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pow2_edge_weights(device):
    """[1, 30, 32] rows (60 groups of 16) whose group amax is 6 x each power
    of two in [2^-10, 448] and its f32 neighbours (global scale 1): local
    scales on every edge of the E4M3 grid."""
    edges = []
    for k in range(-10, 9):
        p = np.float32(2.0 ** k)
        edges += [p, np.nextafter(p, np.float32(0)),
                  np.nextafter(p, np.float32(np.inf))]
    top = np.float32(448.0)
    edges += [top, np.nextafter(top, np.float32(0)),
              np.nextafter(top, np.float32(np.inf))]       # 60 edges
    e = np.asarray(edges, np.float32)
    rng = np.random.default_rng(0)
    w = rng.uniform(-1, 1, (e.size, 16)).astype(np.float32)
    w *= (6.0 * e)[:, None] / np.abs(w).max(-1, keepdims=True)
    w = w.reshape(1, -1, 32)
    return torch.from_numpy(w).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_cuda_bitwise(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    w = torch.randn(6, 256, 192, generator=gen, device=cuda).to(dtype)
    for view in (w, w.transpose(-1, -2)):
        gs = quant.global_scale_for(view)
        pk, sc = qk.quantize_fp4_cuda(view, gs)
        pk_p, sc_p = qk.quantize_fp4_plain(view, gs)
        assert torch.equal(pk, pk_p)
        assert torch.equal(sc.view(torch.int32), sc_p.view(torch.int32))


def test_quantize_cuda_pow2_edges_bitwise(cuda):
    w = _pow2_edge_weights(cuda)
    gs = torch.ones((), device=cuda)
    pk, sc = qk.quantize_fp4_cuda(w, gs)
    pk_p, sc_p = qk.quantize_fp4_plain(w, gs)
    assert torch.equal(pk, pk_p)
    assert torch.equal(sc.view(torch.int32), sc_p.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_cuda_pow2_edges_bitwise_n_contiguous(cuda, dtype):
    """The edge sweep through the staged kernel: the same values as a view
    whose unit stride is N (as the serving path's are)."""
    w = _pow2_edge_weights(cuda).to(dtype)
    view = w.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert view.stride(1) == 1
    gs = torch.ones((), device=cuda)
    pk, sc = qk.quantize_fp4_cuda(view, gs)
    pk_p, sc_p = qk.quantize_fp4_plain(w, gs)
    assert torch.equal(pk, pk_p)
    assert torch.equal(sc.view(torch.int32), sc_p.view(torch.int32))


@pytest.mark.parametrize("shape", [(3, 65, 32), (2, 200, 96), (2, 64, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_cuda_ragged_tiles_bitwise(cuda, shape, dtype):
    """N and K that are not multiples of the staged kernel's 64 x 128
    tile, in both orientations (K contiguous, N contiguous); N = 65 also
    takes the element loads (its K stride is not a multiple of 16 bytes)."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    g, n, k = shape
    w = torch.randn(g, k, n, generator=gen, device=cuda).to(dtype)
    for view in (w.transpose(-1, -2), w.transpose(-1, -2).contiguous()):
        gs = quant.global_scale_for(view)
        pk, sc = qk.quantize_fp4_cuda(view, gs)
        pk_p, sc_p = qk.quantize_fp4_plain(view, gs)
        assert torch.equal(pk, pk_p)
        assert torch.equal(sc.view(torch.int32), sc_p.view(torch.int32))


def _ffn_args(cuda, m, d, f, gs, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    wq = {}
    for name, (rows, cols) in dict(w_gate=(f, d), w_up=(f, d),
                                   w_down=(d, f)).items():
        # 0.3 at a 64-wide contraction, fan-in scaled beyond it, so that
        # outputs stay O(10) and rtol 1e-5 / atol 1e-4 measures the kernel,
        # not the f32 summation order of large partial sums
        w = (torch.randn(len(gs), rows, cols, generator=gen, device=cuda)
             * 0.3 * min(1.0, (64 / cols) ** 0.5)).to(dtype)
        wq[name] = ops.quantize_experts_fp4(w)
    xs = torch.randn(m, d, generator=gen, device=cuda).to(dtype)
    gs_t = torch.tensor(gs, dtype=torch.int32, device=cuda)
    return (xs, gs_t, wq["w_gate"].packed, wq["w_gate"].scales,
            wq["w_up"].packed, wq["w_up"].scales, wq["w_down"].packed,
            wq["w_down"].scales,
            torch.stack([wq[n].global_scale for n in ("w_gate", "w_up",
                                                      "w_down")]))


def check_ffn(y: torch.Tensor, ref: torch.Tensor) -> float:
    """The reference's kernel tolerances: f32 at rtol 1e-5 / atol 1e-4;
    bf16 (a4 cliffs: a rounding difference at a level midpoint moves a
    whole FP4 level) rel-L2 < 3e-2 and peak < 0.1.  Returns max |y - ref|."""
    ya, ra = y.float().cpu(), ref.float().cpu()
    assert ya.shape == ra.shape
    if y.dtype == torch.bfloat16:
        rel_l2 = float((ya - ra).norm() / ra.norm().clamp(min=1e-9))
        assert rel_l2 < 3e-2, rel_l2
        peak = float((ya - ra).abs().max() / ra.abs().max().clamp(min=1e-9))
        assert peak < 0.1, peak
    else:
        torch.testing.assert_close(ya, ra, rtol=1e-5, atol=1e-4)
    return float((ya - ra).abs().max())


@pytest.mark.parametrize("m,d,f,gs", GROUPED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_cuda_matches_plain(cuda, m, d, f, gs, dtype):
    args = _ffn_args(cuda, m, d, f, gs, dtype, m + d + f)
    y = ffn.grouped_fp4_ffn_cuda(*args)
    torch.cuda.synchronize()
    check_ffn(y, ffn.grouped_fp4_ffn_plain(*args))


def test_grouped_ffn_cuda_rows_past_counts_are_zero(cuda):
    args = _ffn_args(cuda, 40, 64, 64, [10, 0, 12], torch.float32, 1)
    y = ffn.grouped_fp4_ffn_cuda(*args)
    assert torch.all(y[22:] == 0)
    check_ffn(y, ffn.grouped_fp4_ffn_plain(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_cuda_zero_rows(cuda, dtype):
    """All-zero rows (the pad slot's unfilled capacity rows) stay exactly 0,
    whole tiles of them and single rows among nonzero ones."""
    gs = [70, 0, 130, 40]
    args = _ffn_args(cuda, 240, 64, 64, gs, dtype, 5)
    xs = args[0]
    xs[70:200] = 0                    # slot 2: two whole zero tiles + part
    xs[210:215] = 0                   # zero rows inside a live tile
    y = ffn.grouped_fp4_ffn_cuda(*args)
    assert torch.all(y[70:200] == 0) and torch.all(y[210:215] == 0)
    check_ffn(y, ffn.grouped_fp4_ffn_plain(*args))


def a4_cliff_rows(args, rel: float) -> torch.Tensor:
    """Rows (bool [M]) whose h = silu(gate)·up, as the plain version computes
    it in f32, holds a value within ``rel`` (relative) of an a4 rounding
    midpoint of its group of 16.  There the last bits of an f32 sum taken
    in another order can move the value a whole FP4 level, which changes
    the row's down product far beyond rtol 1e-5; the reference's small
    cases have no such row, large ones do.  Only f32 arguments."""
    xs, gs, gp, gsc, upk, usc, dp, dsc, gscales = args
    xq = fake_quant_a4(xs)
    deq = lambda p, sc, g: quant.dequantize_fp4(  # noqa: E731
        quant.QTensor(p, sc, g)).transpose(-1, -2).float()
    g = ffn.grouped_matmul(xq, deq(gp, gsc, gscales[0]), gs)
    u = ffn.grouped_matmul(xq, deq(upk, usc, gscales[1]), gs)
    h = torch.nn.functional.silu(g) * u
    hg = h.reshape(h.shape[0], -1, 16)
    scale = torch.clamp(hg.abs().amax(-1, keepdim=True) * INV_FP4_MAX,
                        min=1e-20)
    r = (hg / scale).abs()
    mids = torch.tensor(FP4_MIDPOINTS, device=h.device)
    near = ((r[..., None] - mids).abs() <= rel * mids).any(-1)
    return near.flatten(1).any(-1)


def check_ffn_off_cliffs(y, ref, args, rel: float = 3e-5) -> None:
    """``check_ffn``; in f32, on the rows without an a4 cliff in h
    (``a4_cliff_rows``), which must be at least 90 % of the rows, while
    all rows together stay within the bf16 criterion (rel-L2 < 3e-2)."""
    if y.dtype != torch.float32:
        check_ffn(y, ref)
        return
    cliff = a4_cliff_rows(args, rel)
    assert int(cliff.sum()) <= cliff.numel() // 10, int(cliff.sum())
    check_ffn(y[~cliff], ref[~cliff])
    ya, ra = y.float().cpu(), ref.float().cpu()
    assert float((ya - ra).norm() / ra.norm().clamp(min=1e-9)) < 3e-2


# slot counts around the token-tile widths (8, 16, 32, 64, 128) and past
# one 128-row token tile, then the pad slot without weights
TILE_COUNTS = [0, 1, 7, 8, 9, 17, 63, 64, 65, 128, 255, 256, 257, 300]


@pytest.mark.parametrize("d,f", [(160, 96), (64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_fp4_ffn_cuda_token_tiles(cuda, d, f, dtype):
    """Slots of 0-300 rows (token tiles of every width, several tiles a
    slot), D and F not multiples of 64, a pad slot past the weights and
    rows past every count: the slots with weights match the plain version,
    every other row is exactly 0."""
    n = sum(TILE_COUNTS)
    args = list(_ffn_args(cuda, n + 16, d, f, TILE_COUNTS, dtype, d + f))
    args[1] = torch.tensor(TILE_COUNTS + [11], dtype=torch.int32,
                           device=cuda)
    y = ffn.grouped_fp4_ffn_cuda(*args)
    torch.cuda.synchronize()
    assert torch.all(y[n:] == 0)
    check_ffn_off_cliffs(y, ffn.grouped_fp4_ffn_plain(*args), args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_fp4_ffn_cuda_decode_shape(cuda, dtype):
    """The decode forward's FP4 launch at full width: 8 rows in each of 64
    slots, D 2048, F 1408; with all-zero counts the output is exactly 0."""
    gs = [8] * 64
    args = list(_ffn_args(cuda, 512, 2048, 1408, gs, dtype, 9))
    y = ffn.grouped_fp4_ffn_cuda(*args)
    torch.cuda.synchronize()
    check_ffn_off_cliffs(y, ffn.grouped_fp4_ffn_plain(*args), args)
    args[1] = torch.zeros(64, dtype=torch.int32, device=cuda)
    assert torch.all(ffn.grouped_fp4_ffn_cuda(*args) == 0)


def test_grouped_fp4_ffn_cuda_refuses_too_many_counts(cuda):
    """The bf16 kernel's device schedule holds MAX_SLOTS counts; the
    wrapper refuses more instead of launching."""
    args = list(_ffn_args(cuda, 16, 64, 64, [4, 4], torch.bfloat16, 6))
    args[1] = torch.zeros(ffn.MAX_SLOTS + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        ffn.grouped_fp4_ffn_cuda(*args)


def test_reduced_model_through_kernels_matches_cpu(cuda):
    """Chunked prefill (FP4 firing) then decode of reduced moonshot in f32:
    the card (both kernels launched) against the CPU's plain versions."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    rcfg = ReaLBConfig(gate_gamma=8, md_init=0.0, adaptive=False)
    params = tf.init_model(cfg, seed=0, device="cpu")
    p_gpu = common.tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(0)
    b, s, l = 4, 16, 64
    batch = {"tokens": torch.from_numpy(rng.integers(0, 512, (b, s))
                                        .astype(np.int32)),
             "start": torch.tensor([0, 3, 0, 0], dtype=torch.int32),
             "chunk_len": torch.tensor([16, 10, 0, 5], dtype=torch.int32),
             "modality": torch.from_numpy(rng.random((b, s)) < 0.6)}
    out = {}
    for dev, p in (("cpu", params), (cuda, p_gpu)):
        ops.reset_launch_counts()
        cache = tf.init_cache(cfg, b, l, device=dev)
        m = torch.zeros((1, 4), device=dev)
        res = tf.chunk_forward(p, cfg, rcfg, {k: v.to(dev) for k, v in
                                             batch.items()}, cache, m)
        dec = {"tokens": batch["tokens"][:, :1].to(dev),
               "pos": torch.tensor([16, 13, l, 5], dtype=torch.int32,
                                   device=dev)}
        res2 = tf.decode_forward(p, cfg, rcfg, dec, res.cache, res.m_state)
        out[str(dev)] = (res.logits.cpu(), res2.logits.cpu(),
                         res2.m_state.cpu(), ops.launch_counts(),
                         res.aux["moe_stats"].cpu())
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert set(cpu[3].values()) == {0}
    for name in ("quantize_fp4", "global_scale_fp4", "grouped_fp4_ffn",
                 "grouped_ffn"):
        assert gpu[3][name] > 0, gpu[3]
    torch.testing.assert_close(gpu[0], cpu[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gpu[1], cpu[1], rtol=1e-4, atol=1e-4)
    assert torch.equal(gpu[2], cpu[2]) and torch.equal(gpu[4], cpu[4])


def _plain_ffn_args(cuda, m, d, f, gs, n_w, dtype, seed):
    """xs [m, d], counts gs, plain weights of n_w slots (n_w <= len(gs));
    rows of slots past n_w are zero, as the MoE layer's pad slot's are."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = {}
    for name, (rows, cols) in dict(w_gate=(d, f), w_up=(d, f),
                                   w_down=(f, d)).items():
        w[name] = (torch.randn(n_w, rows, cols, generator=gen, device=cuda)
                   * 0.3 * min(1.0, (64 / rows) ** 0.5)).to(dtype)
    xs = torch.randn(m, d, generator=gen, device=cuda).to(dtype)
    xs[sum(gs[:n_w]):] = 0
    gs_t = torch.tensor(gs, dtype=torch.int32, device=cuda)
    return xs, gs_t, w["w_gate"], w["w_up"], w["w_down"]


def check_plain_ffn(y: torch.Tensor, ref: torch.Tensor) -> float:
    """f32: the reference's rtol 1e-5 / atol 1e-4.  bf16: within two bf16
    ulps (2^-6 relative) of each value and of the output's largest
    magnitude (the tensor cores and cuBLAS accumulate in another order, and
    a one-ulp difference in g or u carries through the bf16 roundings of h
    into the down product).  Returns max |y - ref|."""
    ya, ra = y.float().cpu(), ref.float().cpu()
    assert ya.shape == ra.shape
    if y.dtype == torch.bfloat16:
        tol = 2.0 ** -6 * float(ra.abs().max())
        torch.testing.assert_close(ya, ra, rtol=2.0 ** -6, atol=tol)
    else:
        torch.testing.assert_close(ya, ra, rtol=1e-5, atol=1e-4)
    return float((ya - ra).abs().max())


@pytest.mark.parametrize("m,d,f,gs", GROUPED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_plain_ffn_cuda_matches_plain(cuda, m, d, f, gs, dtype):
    """The BF16 branch's kernel, the last slot a pad slot without weights."""
    args = _plain_ffn_args(cuda, m, d, f, gs, len(gs) - 1, dtype, m + d)
    y = ffn.grouped_ffn_cuda(*args)
    torch.cuda.synchronize()
    check_plain_ffn(y, ffn.grouped_ffn_plain(*args))
    assert torch.all(y[sum(gs[:-1]):] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffns_cuda_zero_counts(cuda, dtype):
    """All-zero counts (the branch the decision did not take): every
    output row is exactly 0."""
    gs = [0, 0, 0, 0]
    plain = _plain_ffn_args(cuda, 64, 64, 64, [20, 30, 14, 0], 4, dtype, 2)
    plain = (plain[0], torch.zeros(4, dtype=torch.int32, device=cuda),
             *plain[2:])
    fp4 = _ffn_args(cuda, 64, 64, 64, gs, dtype, 3)
    assert torch.all(ffn.grouped_ffn_cuda(*plain) == 0)
    assert torch.all(ffn.grouped_fp4_ffn_cuda(*fp4) == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_fp4_ffn_cuda_pad_slot(cuda, dtype):
    """The FP4 kernel with one more count than weight slots (the pad slot):
    its rows stay 0, the others match the plain version."""
    gs = [10, 0, 12, 15]
    args = list(_ffn_args(cuda, 48, 64, 64, gs, dtype, 4))
    args[1] = torch.tensor(gs + [11], dtype=torch.int32, device=cuda)
    args[0][37:] = 0
    y = ffn.grouped_fp4_ffn_cuda(*args)
    assert torch.all(y[37:] == 0)
    check_ffn(y, ffn.grouped_fp4_ffn_plain(*args))


def _quantize_into(w, gs, pred, packed, scales):
    """The quantizer's C entry writing into given buffers."""
    fn = _build.entry("quantize_fp4", qk._ENTRY[w.dtype], qk._ARGTYPES)
    p32 = pred.to(torch.int32).reshape(1)
    _build.check(fn(w.data_ptr(), gs.reshape(1).data_ptr(), packed.data_ptr(),
                    scales.data_ptr(), *w.shape, *w.stride(), p32.data_ptr(),
                    torch.cuda.current_stream(w.device).cuda_stream),
                 "quantize_fp4")
    return packed, scales


def test_quantize_cuda_predicate(cuda):
    """Predicate 0: the quantizer writes nothing into its output buffers;
    predicate 1: bitwise the unpredicated result, global scale included."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    w = torch.randn(4, 96, 64, generator=gen, device=cuda) \
        .to(torch.bfloat16).transpose(-1, -2)
    gs = quant.global_scale_for(w)
    for on in (False, True):
        pred = torch.tensor(on, device=cuda)
        bufs = (torch.full((4, 64, 48), 0xAB, dtype=torch.uint8,
                           device=cuda),
                torch.full((4, 64, 6), -7.0, device=cuda))
        pk, sc = _quantize_into(w, gs, pred, *bufs)
        torch.cuda.synchronize()
        if on:
            pk_p, sc_p = qk.quantize_fp4_plain(w, gs)
            assert torch.equal(pk, pk_p) and torch.equal(sc, sc_p)
            assert torch.equal(qk.global_scale_cuda(w, pred).view(
                torch.int32), gs.view(torch.int32))
        else:
            assert torch.all(pk == 0xAB) and torch.all(sc == -7.0)


def test_quantize_cuda_predicate_k_contiguous(cuda):
    """Predicate 0 writes nothing with K contiguous too (the row kernel)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    w = torch.randn(4, 64, 96, generator=gen, device=cuda).to(torch.bfloat16)
    gs = quant.global_scale_for(w)
    bufs = (torch.full((4, 64, 48), 0xAB, dtype=torch.uint8, device=cuda),
            torch.full((4, 64, 6), -7.0, device=cuda))
    pk, sc = _quantize_into(w, gs, torch.tensor(False, device=cuda), *bufs)
    torch.cuda.synchronize()
    assert torch.all(pk == 0xAB) and torch.all(sc == -7.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_scale_cuda_bitwise(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn(5, 130, 96, generator=gen, device=cuda).to(dtype)
    for view in (w, w[:, :, :64], w[:, :128].transpose(-1, -2)):
        assert torch.equal(qk.global_scale_cuda(view).view(torch.int32),
                           quant.global_scale_for(view).view(torch.int32))


def _scale_equal(view):
    """The kernel's global scale of ``view`` is the plain version's, bitwise
    (both NaN when w holds one)."""
    got = qk.global_scale_cuda(view)
    ref = quant.global_scale_for(view)
    if torch.isnan(ref):
        assert torch.isnan(got)
    else:
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
            (float(got), float(ref))


@pytest.mark.parametrize("perm", list(itertools.permutations(range(3))))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_scale_cuda_dense_permutations(cuda, perm, dtype):
    """Every permutation of a contiguous [G, N, K] block (the flat path),
    bitwise; the serving views are two of them."""
    gen = torch.Generator(device=cuda).manual_seed(sum(perm))
    shape = (5, 130, 96)
    base = torch.randn([shape[p] for p in perm], generator=gen,
                       device=cuda).to(dtype)
    view = base.permute(*np.argsort(perm).tolist())
    assert view.shape == shape and qk.dense(view)
    _scale_equal(view)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_scale_cuda_edges(cuda, dtype):
    """A strided slice (the group path), a base one element past a 16-byte
    boundary, odd numels (heads and tails of the flat path), and a NaN."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    w = torch.randn(4, 130, 96, generator=gen, device=cuda).to(dtype)
    flat = torch.randn(1 + 3 * 37 * 41, generator=gen, device=cuda).to(dtype)
    odd = flat[:3 * 37 * 41].view(3, 37, 41)
    shifted = flat[1:].view(3, 37, 41)
    assert shifted.data_ptr() % 16 and qk.dense(shifted)
    for view in (w[:, ::2], w[:, :, :64], w[:, :128].transpose(-1, -2),
                 odd, shifted, shifted.transpose(0, 2), flat[1:2].view(1, 1, 1),
                 flat[1:16].view(1, 3, 5)):
        _scale_equal(view)
    for view in (w.clone(), w.clone()[:, ::2], w.clone().transpose(-1, -2)):
        view[1, 2, 3] = float("nan")
        _scale_equal(view)


def test_global_scale_cuda_scratch_resets(cuda):
    """Back to back on tensors with falling maxima, and a predicate 0, 1, 0
    sequence: each scale is its own tensor's (the kernel leaves its
    scratch zeroed); a predicate 0 writes nothing."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    ws = [(torch.randn(3, 64, 96, generator=gen, device=cuda) * 10.0 ** -i)
          .to(torch.bfloat16).transpose(-1, -2) for i in range(4)]
    got = [qk.global_scale_cuda(w) for w in ws]
    torch.cuda.synchronize()
    for w, g in zip(ws, got):
        assert torch.equal(g.view(torch.int32),
                           quant.global_scale_for(w).view(torch.int32))
    fn = _build.entry("quantize_fp4", qk._SCALE_ENTRY[torch.bfloat16],
                      qk._SCALE_ARGTYPES)
    scratch = qk._scale_scratch[ws[0].device]
    for i, on in enumerate((0, 1, 0, 1)):
        w = ws[i]
        pred = torch.tensor([on], dtype=torch.int32, device=cuda)
        out = torch.full((1,), -7.0, device=cuda)
        _build.check(fn(w.data_ptr(), pred.data_ptr(), scratch.data_ptr(),
                        out.data_ptr(), *w.shape, *w.stride(),
                        torch.cuda.current_stream(cuda).cuda_stream),
                     "global_scale_fp4")
        torch.cuda.synchronize()
        if on:
            assert torch.equal(out.view(torch.int32), quant.global_scale_for(
                w).reshape(1).view(torch.int32))
        else:
            assert float(out) == -7.0
        assert torch.all(scratch == 0)


def test_global_scale_cuda_one_launch(cuda, tmp_path):
    """One kernel, and no memset or copy, on the device per call."""
    import json

    from torch.profiler import ProfilerActivity, profile
    w = torch.randn(4, 64, 96, device=cuda).to(torch.bfloat16)
    qk.global_scale_cuda(w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            qk.global_scale_cuda(w)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    device = [e["name"] for e in events if e.get("cat") in
              ("kernel", "gpu_memset", "gpu_memcpy")]
    assert len(device) == 3, device


# slot counts around the bf16 design's token-tile widths (8, 16, 32, 64)
# and past one 64-row tile
PLAIN_TILE_COUNTS = [0, 1, 8, 9, 16, 17, 33, 64, 65, 200]


@pytest.mark.parametrize("d,f", [(160, 96), (2048, 1408)])
def test_grouped_plain_ffn_cuda_token_tiles(cuda, d, f):
    """The BF16 branch's bf16 kernel over slots of every token-tile width,
    a pad slot without weights and rows past every count (exactly 0), at a
    narrow shape (D and F not multiples of 64) and at full width; with
    all-zero counts the output is exactly 0."""
    n = sum(PLAIN_TILE_COUNTS)
    gs = PLAIN_TILE_COUNTS + [11]
    args = list(_plain_ffn_args(cuda, n + 11 + 16, d, f, gs, len(gs) - 1,
                                torch.bfloat16, d + f))
    y = ffn.grouped_ffn_cuda(*args)
    torch.cuda.synchronize()
    assert torch.all(y[n:] == 0)
    check_plain_ffn(y, ffn.grouped_ffn_plain(*args))
    args[1] = torch.zeros_like(args[1])
    assert torch.all(ffn.grouped_ffn_cuda(*args) == 0)


def test_grouped_plain_ffn_cuda_refuses_too_many_counts(cuda):
    """The bf16 kernel's device schedule holds MAX_SLOTS counts; the
    wrapper refuses more instead of launching."""
    args = list(_plain_ffn_args(cuda, 16, 64, 64, [4, 4], 2, torch.bfloat16,
                                6))
    args[1] = torch.zeros(ffn.MAX_SLOTS + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        ffn.grouped_ffn_cuda(*args)


def _mm_args(cuda, m, n, k, dtype, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    w = (torch.randn(n, k, generator=gen, device=cuda) * 0.05).to(dtype)
    x = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    packed, scales, gs = ops.quantize_fp4(w)
    return x, packed, scales, gs


@pytest.mark.parametrize("m,n,k", MATMUL_SHAPES)
@pytest.mark.parametrize("a4", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp4_matmul_cuda_matches_plain(cuda, m, n, k, a4, dtype):
    args = _mm_args(cuda, m, n, k, dtype, m + n + k)
    y = mm.fp4_matmul_cuda(*args, a4=a4)
    torch.cuda.synchronize()
    ref = mm.fp4_matmul_plain(*args, a4=a4)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-4)
    # bf16 output: the f32 result rounded once, so within one bf16 ulp
    y16 = mm.fp4_matmul_cuda(*args, a4=a4, out_dtype=torch.bfloat16)
    torch.testing.assert_close(y16.float(), ref, rtol=2.0 ** -8, atol=1e-4)


def _f64_error_ratio(y, x, packed, scales, gs, a4):
    """max |y - y64| / (|x|·|w|)[m, n], y64 the f64 product of the same
    operands (x after its a4, W dequantized in the kernel's order)."""
    xf = x.float()
    if a4:
        xf = fake_quant_a4(xf)
    w = mm.dequantize_kernel_order(packed, scales, gs)
    y64 = xf.double() @ w.double().t()
    mag = xf.double().abs() @ w.double().abs().t()
    err = (y.double() - y64).abs()
    assert bool((err[mag == 0] == 0).all())
    return float((err / mag.clamp_min(1e-300)).max())


@pytest.mark.parametrize("m,n,k", [(300, 1408, 2048), (37, 130, 96)])
@pytest.mark.parametrize("x_scale", [1e-3, 1.0, 1e3])
@pytest.mark.parametrize("a4", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp4_matmul_cuda_scale_free_error(cuda, m, n, k, x_scale, a4,
                                          dtype):
    """Within 1e-6 of (|x|·|w|)[m, n] of an f64 product at any scale of x
    (the fixed atol of the plain-version test is not scale-free)."""
    x, packed, scales, gs = _mm_args(cuda, m, n, k, torch.float32, m + k)
    x = (x * x_scale).to(dtype)
    y = mm.fp4_matmul_cuda(x, packed, scales, gs, a4=a4)
    assert torch.isfinite(y).all()
    assert _f64_error_ratio(y, x, packed, scales, gs, a4) <= 1e-6


@pytest.mark.parametrize("a4", [False, True])
def test_fp4_matmul_cuda_f32_x_near_max(cuda, a4):
    """An x row of ±3.4e38 (above the midpoint between bf16's largest
    finite value and 2^128) against a W row of zeros gives 0: the split of
    f32 x into bf16 terms truncates, where rounding to nearest would make
    inf, and inf · 0 NaN."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    m, n, k = 5, 64, 128
    w = torch.randn(n, k, generator=gen, device=cuda) * 0.05
    w[0] = 0.0
    x = torch.randn(m, k, generator=gen, device=cuda)
    x[0] = 3.4e38 * (1.0 - 2.0 * (torch.arange(k, device=cuda) % 2))
    packed, scales, gs = ops.quantize_fp4(w)
    y = mm.fp4_matmul_cuda(x, packed, scales, gs, a4=a4)
    assert float(y[0, 0]) == 0.0
    ref = mm.fp4_matmul_plain(x, packed, scales, gs, a4=a4)
    torch.testing.assert_close(y[1:], ref[1:], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp4_matmul_cuda_a4_zero_groups(cuda, dtype):
    """a4 over whole groups of zeros (scale 1e-20, every level 0), a zero
    row among them, matches the plain version; the zero row gives 0."""
    x, packed, scales, gs = _mm_args(cuda, 70, 96, 256, dtype, 22)
    x = x.clone()
    x[:, 16:32] = 0
    x[::3, 128:192] = 0
    x[5] = 0
    y = mm.fp4_matmul_cuda(x, packed, scales, gs, a4=True)
    ref = mm.fp4_matmul_plain(x, packed, scales, gs, a4=True)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-4)
    assert bool((y[5] == 0).all())


@pytest.mark.parametrize("m,n", [(3, 200), (130, 257)])
@pytest.mark.parametrize("a4", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp4_matmul_cuda_k32_ragged(cuda, m, n, a4, dtype):
    """K = 32, half a 64-deep stage, with M and N off the 128 tiles."""
    args = _mm_args(cuda, m, n, 32, dtype, m + n)
    ref = mm.fp4_matmul_plain(*args, a4=a4)
    torch.testing.assert_close(mm.fp4_matmul_cuda(*args, a4=a4), ref,
                               rtol=1e-5, atol=1e-4)
    y16 = mm.fp4_matmul_cuda(*args, a4=a4, out_dtype=torch.bfloat16)
    torch.testing.assert_close(y16.float(), ref, rtol=2.0 ** -8, atol=1e-4)


def test_fp4_linear_cuda_counts_its_kernels(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(70, 256, generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn(256, 96, generator=gen, device=cuda) * 0.05) \
        .to(torch.bfloat16)
    ops.reset_launch_counts()
    y = ops.fp4_linear(x, w, a4=True)
    counts = ops.launch_counts()
    assert counts["fp4_matmul"] == 1 and counts["quantize_fp4"] == 1
    assert counts["global_scale_fp4"] == 1
    ref = ops.fp4_linear(x.cpu(), w.cpu(), a4=True)
    torch.testing.assert_close(y.cpu(), ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("policy", ["fp4", "bf16"])
def test_reduced_forwards_are_sync_free(cuda, policy):
    """chunk_forward and decode_forward on the card raise no device-to-host
    sync under set_sync_debug_mode("error"), FP4 firing or not."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    kw = dict(gate_gamma=8, md_init=0.0, adaptive=False) if policy == "fp4" \
        else dict(gate_gamma=10 ** 9)
    rcfg = ReaLBConfig(**kw)
    params = tf.init_model(cfg, seed=0, device=cuda)
    b, s, l = 4, 16, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {"tokens": torch.randint(0, 512, (b, s), generator=gen,
                                     device=cuda, dtype=torch.int32),
             "start": torch.tensor([0, 3, 0, 0], dtype=torch.int32,
                                   device=cuda),
             "chunk_len": torch.tensor([16, 10, 0, 5], dtype=torch.int32,
                                       device=cuda),
             "modality": torch.rand((b, s), generator=gen, device=cuda)
             < 0.6}
    dec = {"tokens": batch["tokens"][:, :1],
           "pos": torch.tensor([16, 13, l, 5], dtype=torch.int32,
                               device=cuda)}
    cache = tf.init_cache(cfg, b, l, device=cuda)
    m = torch.zeros((1, 4), device=cuda)
    tf.chunk_forward(params, cfg, rcfg, batch, cache, m)   # builds kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = tf.chunk_forward(params, cfg, rcfg, batch, cache, m)
        res2 = tf.decode_forward(params, cfg, rcfg, dec, res.cache,
                                 res.m_state)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    fired = float(res.aux["fp4_ranks"]) > 0
    assert fired == (policy == "fp4")
    assert torch.isfinite(res.logits).all() and torch.isfinite(
        res2.logits).all()


@pytest.mark.parametrize("policy", ["fp4", "bf16", "fp4_seq"])
def test_reduced_prefill_is_sync_free(cuda, policy):
    """prefill_forward (one-shot, vision embeds given and ignored) on the
    card raises no device-to-host sync, FP4 firing or not, and under
    ReaLB-seq; its routing stats (per rank and per expert) equal the
    CPU's, its logits are within test_reduced_model_through_kernels_
    matches_cpu's rtol/atol 1e-4 and its cache within rtol 1e-4 and 1e-4
    of the tensor's largest value: the card's chunk_forward parts from the
    CPU's by the same 4.4e-5 of the largest value in the third block's
    cache (this random model amplifies f32 rounding layer by layer, as
    test_torch_model.py says of the reference).  A 16-token prompt, as
    that test uses: on 48 tokens with FP4 forced the logits part by
    1.3e-3 with equal routing stats (not diagnosed)."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    kw = dict(gate_gamma=0, capacity_c=0.0, md_init=0.0, adaptive=False) \
        if policy.startswith("fp4") else dict(gate_gamma=10 ** 9)
    rcfg = ReaLBConfig(**kw, overlap=policy != "fp4_seq")
    params = tf.init_model(cfg, seed=0, device="cpu")
    p_gpu = common.tree_map(lambda t: t.to(cuda), params)
    rng = np.random.default_rng(1)
    s, l = 16, 64
    batch = {"tokens": torch.from_numpy(rng.integers(0, 512, (1, s))
                                        .astype(np.int32)),
             "modality": torch.from_numpy(rng.random((1, s)) < 0.7),
             "vision_embeds": torch.from_numpy(
                 (rng.standard_normal((1, 11, cfg.d_model)) * 0.02)
                 .astype(np.float32))}
    m = torch.zeros((1, 4))
    ref = tf.prefill_forward(params, cfg, rcfg, batch, m, cache_len=l)
    gb = {k: v.to(cuda) for k, v in batch.items()}
    mg = m.to(cuda)
    tf.prefill_forward(p_gpu, cfg, rcfg, gb, mg, cache_len=l)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = tf.prefill_forward(p_gpu, cfg, rcfg, gb, mg, cache_len=l)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = ops.launch_counts()
    assert min(counts[n] for n in ("quantize_fp4", "global_scale_fp4",
                                   "grouped_fp4_ffn", "grouped_ffn")) > 0
    assert (float(res.aux["fp4_ranks"]) > 0) == policy.startswith("fp4")
    torch.testing.assert_close(res.logits.cpu(), ref.logits, rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(res.m_state.cpu(), ref.m_state)
    for k in ("moe_stats", "expert_stats"):
        assert torch.equal(res.aux[k].cpu(), ref.aux[k]), k
    for group in ("prefix", "blocks"):
        for layer, kv in ref.cache[group].items():
            for n in ("k", "v"):
                torch.testing.assert_close(
                    res.cache[group][layer][n].cpu(), kv[n], rtol=1e-4,
                    atol=1e-4 * float(kv[n].abs().max()))


def _bf16_ulp(ref):
    """One bf16 ulp of the tensor's largest magnitude (the bf16 tolerance
    of tests/test_torch_attention.py, which says why)."""
    return 2.0 ** (torch.floor(torch.log2(ref.abs().max().clamp(
        min=1e-30))).item() - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,t", [(2, 8192), (8192, 8192), (3072, 3072)],
                         ids=["decode_8192", "causal_8192", "causal_3072"])
def test_long_kv_attention_card_matches_cpu(cuda, s, t, dtype):
    """scaled_attention past 2048 keys (decode flash, q-blocked chunked
    online softmax) on the card against the CPU, with kv_valid, and the
    chunk-prefill attention against an 8192-row cache; f32 within rtol
    1e-5 / atol 1e-5 (TF32 off), bf16 within one bf16 ulp."""
    from repro_torch.models import attention as attn
    gen = torch.Generator().manual_seed(s + t)
    b, h, kh, d = 2, 16, 16, 128
    q = torch.randn(b, s, h, d, generator=gen).to(dtype)
    k = torch.randn(b, t, kh, d, generator=gen).to(dtype)
    v = torch.randn(b, t, kh, d, generator=gen).to(dtype)
    causal = s == t
    kv_valid = torch.tensor([t, t - 100], dtype=torch.int32)
    calls = [lambda *a: attn.scaled_attention(
        *a[:4], causal=causal, kv_valid=a[4])]
    if not causal:
        q_pos = torch.tensor([[t - 2, t - 1], [100, 101]], dtype=torch.int32)
        calls.append(lambda *a: attn._chunk_attention(*a[:4], q_pos.to(
            a[0].device)))
    for call in calls:
        ref = call(q, k, v, d ** -0.5, kv_valid)
        got = call(*(x.to(cuda) for x in (q, k, v)), d ** -0.5,
                   kv_valid.to(cuda)).cpu()
        assert torch.isfinite(got).all()
        if dtype == torch.float32:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        else:
            diff = (got.float() - ref.float()).abs()
            assert bool((diff <= _bf16_ulp(ref.float())).all()), \
                float(diff.max())


# --------------------------------------------------------------------------
# placement and replication on the card
# --------------------------------------------------------------------------
def _moe_params(device, n_blocks=3, e=16, dtype=torch.bfloat16, seed=0):
    """Seeded stacked expert weights (made on the host, then moved)."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(n_blocks, e, 24, 40, generator=gen).to(dtype)
    moe = {"router": torch.zeros(24, e), "w_gate": w.clone(),
           "w_up": -w.abs(), "w_down": w.transpose(-1, -2).contiguous()}
    return {"blocks": {"layer0": {"moe": {k: v.to(device)
                                          for k, v in moe.items()}}}}


def _same_bytes(a, b):
    for k in ("w_gate", "w_up", "w_down"):
        x = a["blocks"]["layer0"]["moe"][k]
        y = b["blocks"]["layer0"]["moe"][k].cpu()
        assert x.shape == y.shape and torch.equal(
            x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32),
            y.view(torch.int16 if y.dtype == torch.bfloat16 else torch.int32)), k


def _plans(kind, n_blocks=3, e=16):
    """A shared and a per-layer plan of ``kind`` from seeded loads, the
    layout to expand into first (replication), and the undo of each."""
    from repro_torch.placement import migrate as pm
    from repro_torch.placement import planner as pp
    from repro_torch.replication import ReplicaSet
    from repro_torch.replication import migrate as rm
    from repro_torch.replication import planner as rp
    rng = np.random.default_rng(3)
    loads = [np.exp(rng.normal(0, 1.2, e)) for _ in range(n_blocks)]
    if kind == "placement":
        old = pp.plan_identity(e, 4)
        new = [pp.plan_least_loaded(ld, 4) for ld in loads]
        return None, [(pm.diff(old, new[0]), pm.diff(new[0], old)),
                      (pm.diff_layers([old] * n_blocks, new),
                       pm.diff_layers(new, [old] * n_blocks))]
    old = ReplicaSet.identity(e, 4, slots_per_rank=e // 4 + 1,
                              max_replicas=2)
    new = [rp.plan_replication(ld, 4, e // 4 + 1) for ld in loads]
    return old, [(rm.diff(old, new[0]), rm.diff(new[0], old)),
                 (rm.diff_layers([old] * n_blocks, new),
                  rm.diff_layers(new, [old] * n_blocks))]


@pytest.mark.parametrize("kind", ["placement", "replication"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inplace_gather_on_card_equals_cpu(cuda, kind, dtype):
    """The in-place slab gather, the per-layer one and their undo, and the
    slot expansion (shared and per-layer), give the CPU path's bytes."""
    from repro_torch.placement import migrate as pm
    from repro_torch.replication import expand_moe_params
    layout, plans = _plans(kind)
    for expand_by in ([layout] if layout is not None else [None]) + (
            [[layout] * 3] if layout is not None else []):
        host = _moe_params("cpu", dtype=dtype)
        card = _moe_params(cuda, dtype=dtype)
        if expand_by is not None:
            expand_moe_params(host, expand_by)
            expand_moe_params(card, expand_by)
            torch.cuda.synchronize()
            _same_bytes(host, card)
        for plan, undo in plans:
            landed_h, landed_c = [], []
            pm.apply_to_params(host, plan, landed_h)
            pm.apply_to_params(card, plan, landed_c)
            pm.synchronize(card)
            assert landed_h == landed_c
            _same_bytes(host, card)
            pm.undo_blocks(host, undo, landed_h)
            pm.undo_blocks(card, undo, landed_c)
            torch.cuda.synchronize()
            _same_bytes(host, card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_kernels_at_68_slots_with_an_empty_slot(cuda, dtype):
    """The quantizer and the global scale (bitwise) and both grouped FFNs
    (their tolerances) at G = 68 expert slots, one of them an all-zero
    empty spare (zeroed by the mask multiply: -0.0 where the weight was
    negative), with the pad slot's counts after it."""
    gen = torch.Generator(device=cuda).manual_seed(68)
    d, f, g = 256, 192, 68
    w = {n: (torch.randn(g, *s, generator=gen, device=cuda)
             * 0.3 * min(1.0, (64 / s[0]) ** 0.5)).to(dtype)
         for n, s in dict(w_gate=(d, f), w_up=(d, f), w_down=(f, d)).items()}
    for t in w.values():
        t[37].mul_(0.0)                        # the empty spare slot
    assert (w["w_gate"][37].view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32) < 0).any()   # -0.0 kept
    wq = {}
    for n, t in w.items():
        view = t.transpose(-1, -2)
        gs_k = qk.global_scale_cuda(view)
        gs_p = quant.global_scale_for(view)
        assert torch.equal(gs_k.view(torch.int32), gs_p.view(torch.int32)), n
        pk, sc = qk.quantize_fp4_cuda(view, gs_p)
        pk_p, sc_p = qk.quantize_fp4_plain(view, gs_p)
        assert torch.equal(pk, pk_p) and torch.equal(
            sc.view(torch.int32), sc_p.view(torch.int32)), n
        wq[n] = ops.quantize_experts_fp4(view)
    counts = [int(c) for c in torch.randint(0, 9, (g,), generator=gen,
                                            device=cuda).tolist()]
    counts[37] = 0
    counts += [5]                               # the pad slot
    m = sum(counts)
    xs = torch.randn(m, d, generator=gen, device=cuda).to(dtype)
    xs[sum(counts[:g]):] = 0
    gs_t = torch.tensor(counts, dtype=torch.int32, device=cuda)
    fp4_args = (xs, gs_t, wq["w_gate"].packed, wq["w_gate"].scales,
                wq["w_up"].packed, wq["w_up"].scales, wq["w_down"].packed,
                wq["w_down"].scales,
                torch.stack([wq[n].global_scale.reshape(()) for n in
                             ("w_gate", "w_up", "w_down")]).float())
    check_ffn(ffn.grouped_fp4_ffn_cuda(*fp4_args),
              ffn.grouped_fp4_ffn_plain(*fp4_args))
    plain_args = (xs, gs_t, w["w_gate"], w["w_up"], w["w_down"])
    check_plain_ffn(ffn.grouped_ffn_cuda(*plain_args),
                    ffn.grouped_ffn_plain(*plain_args))


@pytest.mark.parametrize("kind", ["placement", "replication"])
def test_manager_driven_engine_is_sync_free(cuda, kind, monkeypatch):
    """A reduced-moonshot engine with a per-layer manager (weighted split
    for replication) serves on the card with every forward under
    set_sync_debug_mode("error"), migrating in between, and gives the
    tokens the same engine gives on the CPU."""
    from repro_torch.configs import PlacementConfig, ReplicationConfig
    from repro_torch.placement import PlacementManager
    from repro_torch.replication import ReplicaManager, expand_moe_params
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg.vocab_size, 14).astype(np.int32),
             rng.random(14) < 0.6) for _ in range(5)]

    def run(device, checked):
        kw = dict(replan_every=3, warmup_iters=1, min_gain=0.0,
                  per_layer=True)
        if kind == "placement":
            mgr = PlacementManager(cfg, PlacementConfig(**kw), 4)
        else:
            mgr = ReplicaManager(cfg, ReplicationConfig(
                weighted_split=True, **kw), 4)
        params = common.tree_map(lambda t: t.to(device),
                                 tf.init_model(cfg, seed=0, device="cpu"))
        if kind == "replication":
            expand_moe_params(params, mgr.rsets)
        eng = Engine(cfg, params, ReaLBConfig(gate_gamma=8, md_init=0.0),
                     max_slots=3, max_len=48, prefill_budget=16,
                     placement=mgr, migrate_async=True,
                     migrate_bytes_per_iter=1, device=device)
        for uid, (tok, mod) in enumerate(reqs):
            eng.submit(Request(uid=uid, tokens=tok, modality=mod,
                               max_new_tokens=6))
        done = {r.uid: r.generated for r in eng.run()}
        assert mgr.n_migrations > 0 and len(done) == len(reqs)
        return done

    cpu = run("cpu", {})
    saved = {n: getattr(tf, f"{n}_forward") for n in ("chunk", "decode")}
    checked = {}

    def wrap(name, fn):
        def go(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                checked[name] = checked.get(name, 0) + 1
        return go

    for name, fn in saved.items():
        monkeypatch.setattr(tf, f"{name}_forward", wrap(name, fn))
    assert run(cuda, checked) == cpu
    assert checked.get("chunk", 0) > 0 and checked.get("decode", 0) > 0


def _elastic_case(device, tmp_path):
    """A shared-table replica manager over 8 experts and 4 ranks (one
    spare slot each), its stacked [2, 12, 4, 6] weights on ``device`` and a
    checkpoint of them written from the host."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.replication import ReplicaManager, expand_moe_params
    from repro_torch.configs import ReplicationConfig
    mgr = ReplicaManager.from_geometry(
        8, ReplicationConfig(replan_every=1, warmup_iters=0, min_gain=0.0,
                             spare_per_rank=1, max_replicas=3), 4,
        bytes_per_expert=64)
    rng = np.random.default_rng(11)
    params = {"blocks": {"layer0": {"moe": {
        k: torch.from_numpy(rng.normal(size=(2, 8, 4, 6)).astype(np.float32))
        .to(torch.bfloat16) for k in ("w_gate", "w_up", "w_down")}}}}
    expand_moe_params(params, mgr.rset)
    if not (tmp_path / "ck").exists():
        ckpt.save(str(tmp_path / "ck"), 0, {
            "serving": {"params": params}, "replication": mgr.state_dict()})
    return mgr, common.tree_map(lambda t: t.to(device), params)


def test_elastic_zero_and_patch_on_card_equal_cpu(cuda, tmp_path):
    """The dead rank's in-place zeroing and the in-place re-materialization
    of its experts from the checkpoint give the CPU's bytes."""
    from repro_torch.serving.async_migrate import MigrationExecutor
    from repro_torch.serving.elastic import ElasticCoordinator
    out = {}
    for device in ("cpu", cuda):
        mgr, params = _elastic_case(device, tmp_path)
        co = ElasticCoordinator(mgr, ckpt_dir=str(tmp_path / "ck"))
        co.fail_rank(1, params)
        zeroed = common.tree_map(lambda t: t.to("cpu", copy=True), params)
        mgr.observe(np.stack([np.stack([np.arange(8.0) + 1,
                                        np.zeros(8)])]))
        plan = mgr.maybe_replan(1)
        ex = MigrationExecutor(mgr, plan, bytes_per_iter=1 << 30,
                               priority_layers=co.recovery_layers(plan),
                               patch_fn=co.patch_params)
        while ex.draining:
            params, rep = ex.drain(params)
            co.on_layers_landed(plan, rep.layers)
        torch.cuda.synchronize()
        assert not co.recovering and co.patched_bytes > 0
        out[str(device)] = (zeroed, common.tree_map(lambda t: t.cpu(),
                                                    params))
    for a, b in zip(out["cpu"], out["cuda"]):
        for k in ("w_gate", "w_up", "w_down"):
            x, y = (t["blocks"]["layer0"]["moe"][k] for t in (a, b))
            assert torch.equal(x.view(torch.int16), y.view(torch.int16)), k


def test_sentinel_on_card_catches_pulls_and_op_syncs(cuda):
    """Inside a hot window on the card: ``.item()`` is caught by the method
    patch, ``nonzero`` by the sync debug mode (warned and recorded, or
    raised under strict); a sanctioned read passes, and the mode is back to
    its default after the window."""
    from repro_torch.analysis import Sentinel
    x = torch.arange(8, device=cuda)
    s = Sentinel()
    with s.hot("iter"):
        x.sum().item()
        torch.nonzero(x > 3)
        with s.sanctioned("telemetry"):
            x.cpu().tolist()
    kinds = [v.kind for v in s.violations]
    assert kinds.count("host_sync") == 1 and kinds.count("cuda_sync") >= 1
    assert all("test_torch_cuda" in v.where for v in s.violations)
    assert torch.cuda.get_sync_debug_mode() == 0
    strict = Sentinel(strict=True)
    with pytest.raises(RuntimeError, match="synchroniz"):
        with strict.hot("iter"):
            torch.nonzero(x > 3)
    assert [v.kind for v in strict.violations] == ["cuda_sync"]
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.parametrize("mode", ["dispatch", "broadcast"])
def test_phase_timer_on_card_is_the_fused_layer(cuda, mode):
    """``time_moe_phases`` (CUDA events) returns the layer's own output,
    bit for bit, with FP4 firing."""
    from repro_torch.core import ep_moe
    from repro_torch.obs import MOE_STAGES, time_moe_phases
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    params = tf.init_model(cfg, seed=0, device=cuda)
    p = {k: v[0] for k, v in params["blocks"]["layer0"]["moe"].items()
         if k in ("router", "w_gate", "w_up", "w_down")}
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, s = (2, 24) if mode == "dispatch" else (12, 1)
    x = torch.randn(b, s, cfg.d_model, generator=gen, device=cuda) * 0.5
    mod = torch.rand((b, s), generator=gen, device=cuda) < 0.6
    rcfg = ReaLBConfig(gate_gamma=8, md_init=0.0, adaptive=False)
    m = torch.zeros((1, 4), device=cuda)
    secs, (y, m2, aux) = time_moe_phases(p, x, cfg, rcfg, m, mode=mode,
                                         modality=mod, repeats=2)
    assert set(secs) == set(MOE_STAGES[mode])
    y_r, m_r, aux_r = ep_moe.ep_moe_forward(p, x, cfg, rcfg, m, mod,
                                            mode=mode)
    assert torch.equal(y, y_r) and torch.equal(m2, m_r)
    assert all(torch.equal(aux[k], aux_r[k]) for k in aux)
    assert float(aux["fp4_ranks"]) > 0


def test_elastic_engine_on_card_under_strict_sentinel(cuda, tmp_path):
    """A reduced-moonshot engine with a per-layer replica manager, a kill
    before the first replan and a rejoin, a tracer, a profiler and a
    strict sentinel: no sync in any hot window (uploads included), no new
    input signature in a second pass, and the CPU's tokens."""
    from repro_torch.analysis import Sentinel
    from repro_torch.configs import ReplicationConfig
    from repro_torch.obs import FlopByteLedger, Profiler, Tracer
    from repro_torch.replication import ReplicaManager, expand_moe_params
    from repro_torch.runtime.fault_tolerance import FaultInjector
    from repro_torch.serving.elastic import ElasticCoordinator
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
             rng.random(n) < 0.6) for n in (5, 12, 20, 9, 16, 3)]

    def run(device):
        mgr = ReplicaManager(cfg, ReplicationConfig(
            replan_every=4, warmup_iters=2, min_gain=0.0, per_layer=True,
            spare_per_rank=1, max_replicas=2), 4)
        ck = tmp_path / str(device)
        co = ElasticCoordinator(mgr, ckpt_dir=str(ck))
        params = common.tree_map(lambda t: t.to(device),
                                 tf.init_model(cfg, seed=0, device="cpu"))
        sent = Sentinel(strict=True)
        eng = Engine(cfg, expand_moe_params(params, mgr.rsets),
                     ReaLBConfig(gate_gamma=8, md_init=0.0), max_slots=3,
                     max_len=48, prefill_budget=16, placement=mgr,
                     migrate_async=True, migrate_bytes_per_iter=1,
                     elastic=co, tracer=Tracer(),
                     profiler=Profiler(FlopByteLedger(cfg, ep=4)),
                     fault_injector=FaultInjector([(3, "fail", 2),
                                                   (12, "rejoin", 2)]),
                     sentinel=sent, device=device)
        eng.save_checkpoint(str(ck), 0)
        toks = []
        for rnd in range(2):
            for uid, (tok, mod) in enumerate(reqs):
                eng.submit(Request(uid=10 * rnd + uid, tokens=tok,
                                   modality=mod, max_new_tokens=6))
            toks.append({r.uid: r.generated for r in eng.run()})
            eng.drain_migrations()
            if rnd == 0:
                sent.mark_warm()
        assert any(s.n_unroutable > 0 for s in eng.stats)
        assert co.last_recovery_s is not None and mgr.rank_alive.all()
        assert sent.violations == [] and sent.post_warm_recompiles() == {}
        return toks

    assert run(cuda) == run("cpu")


def _card_gather_case():
    rng = np.random.default_rng(9)
    n_blocks, slots = 3, 16
    tree = {"blocks": {"layer0": {"moe": {
        k: rng.standard_normal((n_blocks, slots) + shape).astype(np.float32)
        for k, shape in (("w_gate", (64, 96)), ("w_up", (64, 96)),
                         ("w_down", (96, 64)))}}}}
    rows = np.stack([rng.permutation(slots), np.arange(slots),
                     rng.permutation(slots)])
    return {"tree": tree, "rows": rows, "width": 40}


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    """Two ranks spawned on the one card, the staged backend (host copies
    around gloo): their results of ``_torch_ep_workers.card_gather``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from _torch_dist import run_ranks
    from _torch_ep_workers import card_gather
    case = _card_gather_case()
    return case, run_ranks(card_gather, (1, 2), case,
                           tmp_path_factory.mktemp("card_gather"))


def test_staged_row_exchange_on_card(card_ranks):
    """``Comm.exchange_rows`` between two ranks on the card: rows of
    uneven counts from pair to pair arrive in rank order, bit for bit, and
    the census counts the bytes each rank sent."""
    _, out = card_ranks
    for r in out:
        assert r["exchange"] and r["exchange_bytes"]


def test_crossrank_inplace_gather_on_card_equals_one_device(card_ranks):
    """A per-layer plan (two permuted blocks, one identity) gathered in
    place on each rank's bf16 slots, the rows from the other rank coming
    through the staged exchange: each rank's slots equal its slice of the
    one-device gather of the whole stack on the card, bit for bit, and it
    sent exactly the plan's rows whose source it holds."""
    from repro_torch.placement.migrate import crossrank_sends
    case, out = card_ranks
    row_bytes = 3 * 64 * 96 * 2
    sends = crossrank_sends(case["rows"], 2)
    for my, r in enumerate(out):
        assert r["gather"]
        assert r["landed"] == [("blocks", "layer0", 0),
                               ("blocks", "layer0", 2)]
        assert r["sent"] == int(sends[:, my].sum()) * row_bytes


# --------------------------------------------------------------------------
# the compiled step: CUDA graphs of the chunk and decode forwards
# --------------------------------------------------------------------------
def _bits_equal(a, b) -> bool:
    """Two trees of tensors (dicts, tuples) hold the same bytes."""
    if isinstance(a, dict):
        return set(a) == set(b) and all(_bits_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_bits_equal, a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def step_body(fwd, cfg, rcfg, bufs):
    """The body a ``StepGraphs`` runs for ``fwd`` (``chunk_forward`` or
    ``decode_forward``): the forward on the static input buffers ``bufs``
    over the cache it is given, ``m_state`` written in place."""
    def body(params, cache, m):
        res = fwd(params, cfg, rcfg, bufs, cache, m)
        m.copy_(res.m_state)
        return res.logits, res.aux
    return body


def graphed_equals_eager(sg, sent, kind, fwd, params, cfg, rcfg, state,
                         origin, m0, inputs, label) -> float:
    """One step of ``sg``'s graph ``kind`` on ``inputs`` (the eager first
    call, captured after, or a replay) inside ``sent``'s hot window, from
    ``origin``'s cache and ``m0`` copied into ``state`` (the cache and
    ``m_state`` the graphs read and write in place).  Raises unless it
    equals the eager ``fwd`` on copies of ``origin`` and ``m0`` bit for
    bit: the logits, every statistic, the cache (KV rows and Mamba
    states) and ``m_state``.  Returns the FP4 virtual ranks it fired."""
    cache, m = state
    with sent.hot(label):
        common.tree_map(lambda dst, src: dst.copy_(src), cache, origin)
        m.copy_(m0)
        body = step_body(fwd, cfg, rcfg, sg.inputs(kind, inputs))
        logits, aux = sg.run(kind, kind, body, (params, cache, m))
    want = fwd(params, cfg, rcfg, inputs,
               common.tree_map(lambda t: t.clone(), origin), m0.clone())
    if not _bits_equal((logits, aux, cache, m),
                       (want.logits, want.aux, want.cache, want.m_state)):
        raise AssertionError(f"{label}: the graphed step differs from the "
                             "eager forward")
    return float(aux["fp4_ranks"])


def test_graph_replay_equals_eager_forwards(cuda):
    """One captured graph each for a reduced-moonshot chunk and decode
    step serves FP4 on and off (vision or all-text inputs; the decision is
    read on the device): every replay equals the eager forward bit for
    bit (logits, statistics, cache, m_state), under a strict sentinel (0
    syncs), and the capture's kernel launches are counted per replay."""
    from repro_torch.analysis import Sentinel
    from repro_torch.serving.graphs import StepGraphs
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    params = tf.init_model(cfg, seed=0, device=cuda)
    rcfg = ReaLBConfig(gate_gamma=0, capacity_c=0.0, md_init=0.0,
                       adaptive=False)
    b, s, l = 4, 16, 48
    gen = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device=cuda, dtype=torch.int32)
    vis = torch.rand((b, s), generator=gen, device=cuda) < 0.6
    i32 = dict(dtype=torch.int32, device=cuda)
    inputs = {
        "chunk": {fp4: {"tokens": tok, "start": torch.tensor([0, 4, 0, 9],
                                                             **i32),
                        "chunk_len": torch.tensor([16, 7, 0, 12], **i32),
                        "modality": vis if fp4 else torch.zeros_like(vis)}
                  for fp4 in (True, False)},
        "decode": {fp4: {"tokens": tok[:, :1].contiguous(),
                         "pos": torch.tensor([16, l, 3, 20], **i32),
                         "modality": torch.full((b, 1), fp4, device=cuda),
                         "valid": torch.tensor([[True], [False], [True],
                                                [True]], device=cuda)}
                   for fp4 in (True, False)}}
    fwds = {"chunk": tf.chunk_forward, "decode": tf.decode_forward}
    origin = tf.init_cache(cfg, b, l, device=cuda)
    tf.chunk_forward(params, cfg, rcfg, inputs["chunk"][True], origin,
                     torch.zeros((1, 4), device=cuda))
    m0 = torch.rand((1, 4), generator=gen, device=cuda)
    cache = common.tree_map(lambda t: t.clone(), origin)
    m = m0.clone()
    sent = Sentinel(strict=True)
    sg = StepGraphs(cuda, sentinel=sent)
    bufs = {}

    def body_for(kind):
        def body(params, cache, m):
            res = fwds[kind](params, cfg, rcfg, bufs[kind], cache, m)
            m.copy_(res.m_state)
            return res.logits, res.aux
        return body

    def reset():
        for n in ("blocks", "prefix"):
            for name, kv in cache.get(n, {}).items():
                for k in ("k", "v"):
                    kv[k].copy_(origin[n][name][k])
        m.copy_(m0)

    ops.reset_launch_counts()
    per_call = {}
    for kind in ("chunk", "decode"):
        for fp4 in (True, False, True):
            reset()
            with sent.hot(kind):
                bufs[kind] = sg.inputs(kind, inputs[kind][fp4])
                before = ops.launch_counts()
                logits, aux = sg.run(kind, kind, body_for(kind),
                                     (params, cache, m))
                after = ops.launch_counts()
            per_call.setdefault(kind, []).append(
                {k: after[k] - before[k] for k in after})
            want = fwds[kind](params, cfg, rcfg, inputs[kind][fp4],
                              common.tree_map(lambda t: t.clone(), origin),
                              m0.clone())
            assert _bits_equal((logits, aux, cache, m),
                               (want.logits, want.aux, want.cache,
                                want.m_state)), (kind, fp4)
            assert (float(aux["fp4_ranks"]) > 0) == fp4
    assert sg.captures == {"chunk": 1, "decode": 1} and not sg.dropped
    assert sg.replays == {"chunk": 2, "decode": 2}
    assert sent.violations == [] and sent.sanctioned_pulls == {"capture": 2}
    for kind, calls in per_call.items():
        # the eager first call, then each replay, launch the same kernels
        assert calls[0] == calls[1] == calls[2], (kind, calls)
        assert calls[0]["quantize_fp4"] > 0 \
            and calls[0]["grouped_fp4_ffn"] > 0


def _graph_engine_run(cuda, graphs, kind=None, passes=1, sentinel=None,
                      load_at=None, tmp_path=None, **engine_kw):
    """A reduced-moonshot engine on the card (``kind``: a shared placement
    table migrating synchronously, or none) serving five requests per
    pass; returns (tokens by pass, engine)."""
    from repro_torch.configs import PlacementConfig
    from repro_torch.placement import PlacementManager
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
             rng.random(n) < 0.6) for n in (14, 5, 22, 9, 17)]
    mgr = None
    if kind == "placement":
        mgr = PlacementManager(cfg, PlacementConfig(
            planner="least_loaded", replan_every=3, warmup_iters=1,
            min_gain=0.0), 4)
    eng = Engine(cfg, tf.init_model(cfg, seed=0, device=cuda),
                 ReaLBConfig(gate_gamma=8, md_init=0.0), max_slots=3,
                 max_len=48, prefill_budget=16, virtual_ep=4,
                 placement=mgr, sentinel=sentinel, device=cuda,
                 graphs=graphs, **engine_kw)
    out = []
    for p in range(passes):
        for uid, (tok, mod) in enumerate(reqs):
            eng.submit(Request(uid=10 * p + uid, tokens=tok, modality=mod,
                               max_new_tokens=6))
        n0 = len(eng.scheduler.finished)
        while not eng.scheduler.idle:
            eng.step()
            if load_at is not None and eng._it == load_at:
                eng.save_checkpoint(str(tmp_path), 1)
                eng.load_checkpoint(str(tmp_path))
        out.append({r.uid: r.generated for r in eng.scheduler.finished[n0:]})
        if sentinel is not None and p == 0:
            sentinel.mark_warm()
    return out, eng


def test_graphed_engine_is_sync_free_with_no_new_capture(cuda):
    """The default engine on the card is graphed: under a strict sentinel
    it serves two passes with 0 syncs and no new capture in the second,
    the eager engine's tokens, and the same kernel launches (a replay
    counts what its capture recorded)."""
    from repro_torch.analysis import Sentinel
    sent = Sentinel(strict=True)
    ops.reset_launch_counts()
    got, eng = _graph_engine_run(cuda, None, passes=2, sentinel=sent)
    graphed = ops.launch_counts()
    assert eng.step_mode == "graphed" and sent.step == "graphed"
    assert sent.violations == [] and sent.post_warm_recompiles() == {}
    assert sent.ok and sum(eng._graphs.replays.values()) > 0
    ops.reset_launch_counts()
    want, _ = _graph_engine_run(cuda, False, passes=2)
    assert got == want
    assert graphed == ops.launch_counts()


def test_graphed_engine_commit_seen_without_recapture(cuda):
    """Synchronous placement commits between replays: the tables are
    written into the same buffers and the weights gathered in place, so
    the next replay routes by the new table with no recapture, and the
    tokens are the eager engine's."""
    got, eng = _graph_engine_run(cuda, True, kind="placement")
    want, ref = _graph_engine_run(cuda, False, kind="placement")
    assert eng._placement.n_migrations > 0
    assert eng._placement.n_migrations == ref._placement.n_migrations
    assert eng._graphs.dropped == [] and \
        sum(eng._graphs.recaptures.values()) == 0
    assert sum(eng._graphs.replays.values()) > 0
    assert got == want


def test_graphed_engine_recaptures_after_a_checkpoint_load(cuda, tmp_path):
    """A checkpoint load between two steps replaces every weight tensor:
    the graphs are dropped (declared) and captured again, and the tokens
    are the eager engine's."""
    got, eng = _graph_engine_run(cuda, True, load_at=4,
                                 tmp_path=tmp_path / "g")
    want, _ = _graph_engine_run(cuda, False, load_at=4,
                                tmp_path=tmp_path / "e")
    assert len(eng._graphs.dropped) == 1
    assert sum(eng._graphs.recaptures.values()) >= 1
    assert got == want



def test_graphed_forward_seconds_cover_device_work(cuda, monkeypatch):
    """On the wall clock, each forward's seconds (what a ``Profiler``'s
    MFU, phase seconds and ``time_scale`` are made of) run to its
    statistics on the host, so they cover the device work between CUDA
    events recorded around the forward's call, graphed (where the call
    returns once the replay is enqueued) and eager alike; both engines
    split each iteration's seconds over the phases in the same shares."""
    from repro_torch.obs import FlopByteLedger, Profiler
    from repro_torch.serving.engine import Engine
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    forward, spans = Engine._forward, []

    def timed(self, name, arrays):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        res = forward(self, name, arrays)
        e1.record()
        spans.append((e0, e1))
        return res
    monkeypatch.setattr(Engine, "_forward", timed)
    out = {}
    for graphs in (True, False):
        spans.clear()
        prof = Profiler(FlopByteLedger(cfg, ep=4))
        got, eng = _graph_engine_run(cuda, graphs, profiler=prof,
                                     clock=time.perf_counter)
        torch.cuda.synchronize()
        dev_s = sum(e0.elapsed_time(e1) for e0, e1 in spans) / 1e3
        assert eng.step_mode == ("graphed" if graphs else
                                 "eager (graphs=False)")
        assert prof.n_iters == len(spans) > 0
        assert prof.fwd_s_total >= dev_s > 0, (graphs, prof.fwd_s_total,
                                               dev_s)
        assert 0 < prof.mfu() < 1
        out[graphs] = (got, prof)
    assert out[True][0] == out[False][0]
    # the same stats: each iteration's seconds split in the same shares
    assert out[True][1].phase_seconds_pred() == \
        out[False][1].phase_seconds_pred()
    for _, p in out.values():
        assert sum(p.phase_seconds().values()) == pytest.approx(
            p.fwd_s_total, rel=1e-9)


def test_graphed_working_launches_counted_on_the_device(cuda):
    """With the device counter tracking before capture, a graphed engine's
    replays count the launches that did work, and they equal the eager
    engine's on the same stream (the same FP4 decisions)."""
    from repro_torch.kernels import working
    counts = {}
    working.track(torch.device("cuda"))
    ptr = working._counter.data_ptr()
    working.track(torch.device("cuda", torch.cuda.current_device()))
    assert working._counter.data_ptr() == ptr    # zeroed where it lies
    try:
        for graphs in (True, False):
            working.track(cuda)
            ops.reset_launch_counts()
            _, eng = _graph_engine_run(cuda, graphs)
            counts[graphs] = (working.counts(), ops.launch_counts())
            assert (sum(eng._graphs.replays.values()) > 0) == graphs
    finally:
        working.track(None)
    assert counts[True] == counts[False]
    work, launched = counts[True]
    assert all(0 <= work[k] <= launched[k] for k in work)
    assert work["grouped_ffn"] + work["grouped_fp4_ffn"] > 0


# --------------------------------------------------------------------------
# the grouped FFN's backward kernel (training)
# --------------------------------------------------------------------------
def check_ffn_bwd(got, ref) -> float:
    """The backward kernel's four outputs against its plain version's.
    f32: the reference's kernel tolerance, rtol 1e-5 / atol 1e-4.  bf16:
    within two bf16 ulps (2^-6 relative) of each value and of the output's
    largest magnitude (both accumulate in f32 from the same bf16 inputs,
    in another order, and round once; a one-ulp flip of a recomputed g or
    u moves one term of a sum).  Returns the largest |got - ref|."""
    err = 0.0
    for name, y, r in zip(("dxs", "dw_gate", "dw_up", "dw_down"), got, ref):
        ya, ra = y.float().cpu(), r.float().cpu()
        assert ya.shape == ra.shape and y.dtype == r.dtype, name
        if y.dtype == torch.bfloat16:
            tol = 2.0 ** -6 * float(ra.abs().max())
            torch.testing.assert_close(ya, ra, rtol=2.0 ** -6, atol=tol,
                                       msg=name)
        else:
            torch.testing.assert_close(ya, ra, rtol=1e-5, atol=1e-4,
                                       msg=name)
        err = max(err, float((ya - ra).abs().max()))
    return err


def _bwd_args(cuda, m, d, f, gs, n_w, dtype, seed):
    """The plain FFN's inputs (:func:`_plain_ffn_args`) and a gradient
    ``dy`` of the output, zero on rows no slot with weights covers (the
    layer's gradient there is 0: those outputs are constant 0)."""
    args = _plain_ffn_args(cuda, m, d, f, gs, n_w, dtype, seed)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    dy = torch.randn(m, d, generator=gen, device=cuda).to(dtype)
    dy[sum(gs[:n_w]):] = 0
    return (*args, dy)


# the reference's GROUPED_CASES and slots of 1, 17, 63, 64 and 65 rows (a
# weight gradient's last row tile ends inside the next slot's rows), each
# with the weights of every slot and with the last slot a pad slot without
# weights (Gw < G)
BWD_CASES = [(m, d, f, gs, n_w) for m, d, f, gs in GROUPED_CASES + [
    (224, 64, 96, [1, 17, 63, 64, 65])]
    for n_w in (len(gs), len(gs) - 1)]
# moonshot's widths at a few hundred rows.  bf16 against the plain version;
# f32 against an f64 evaluation of the same chain (``f64_yardstick``): at
# a 2048-deep recompute cuBLAS's own f32 GEMMs lie ~3.7e-4 from it, past
# the atol of 1e-4, and so does the reference's f32 jax.vjp (~2e-4,
# ``_torch_bwd_wide.py``)
BWD_WIDE_CASES = [(448, 2048, 1408, [100, 0, 37, 200, 65, 30], n_w)
                  for n_w in (6, 5)]


def f64_yardstick(args):
    """The plain backward evaluated in f64 on f32 ``args``, rounded to f32:
    what ``check_ffn_bwd`` holds the f32 entry against at full width."""
    return tuple(t.float() for t in ffn.grouped_ffn_bwd_plain(
        *(a.double() if a.is_floating_point() else a for a in args)))


@pytest.mark.parametrize("m,d,f,gs,n_w", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_bwd_cuda_matches_plain(cuda, m, d, f, gs, n_w, dtype):
    args = _bwd_args(cuda, m, d, f, gs, n_w, dtype, m + d + n_w)
    got = ffn.grouped_ffn_bwd_cuda(*args)
    torch.cuda.synchronize()
    check_ffn_bwd(got, ffn.grouped_ffn_bwd_plain(*args))
    assert torch.all(got[0][sum(gs[:n_w]):] == 0)


@pytest.mark.parametrize("m,d,f,gs,n_w", BWD_WIDE_CASES)
def test_grouped_ffn_bwd_cuda_matches_plain_at_full_width(cuda, m, d, f, gs,
                                                          n_w):
    args = _bwd_args(cuda, m, d, f, gs, n_w, torch.bfloat16, m + d + n_w)
    got = ffn.grouped_ffn_bwd_cuda(*args)
    torch.cuda.synchronize()
    check_ffn_bwd(got, ffn.grouped_ffn_bwd_plain(*args))
    assert torch.all(got[0][sum(gs[:n_w]):] == 0)


@pytest.mark.parametrize("m,d,f,gs,n_w", BWD_WIDE_CASES)
def test_grouped_ffn_bwd_f32_at_full_width_matches_f64(cuda, m, d, f, gs,
                                                       n_w):
    """The f32 entry at moonshot's widths under ``check_ffn_bwd``'s f32
    tolerance (rtol 1e-5 / atol 1e-4), against the f64 evaluation of its
    chain (the plain version's cuBLAS f32 is itself past that tolerance
    there)."""
    args = _bwd_args(cuda, m, d, f, gs, n_w, torch.float32, m + d + n_w)
    got = ffn.grouped_ffn_bwd_cuda(*args)
    torch.cuda.synchronize()
    check_ffn_bwd(got, f64_yardstick(args))
    assert torch.all(got[0][sum(gs[:n_w]):] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_bwd_cuda_edges(cuda, dtype):
    """Rows past sum(gs) (nonzero inputs there) give dx 0 and no weight
    gradient; all-zero counts give all-zero outputs."""
    gs = [10, 0, 12]
    args = list(_bwd_args(cuda, 40, 64, 96, gs, 3, dtype, 7))
    gen = torch.Generator(device=cuda).manual_seed(8)
    args[0][22:] = torch.randn(18, 64, generator=gen, device=cuda).to(dtype)
    args[5][22:] = 1.0
    got = ffn.grouped_ffn_bwd_cuda(*args)
    assert torch.all(got[0][22:] == 0)
    check_ffn_bwd(got, ffn.grouped_ffn_bwd_plain(*args))
    args[1] = torch.zeros(3, dtype=torch.int32, device=cuda)
    got = ffn.grouped_ffn_bwd_cuda(*args)
    assert all(torch.all(t == 0) for t in got)


def _first_in_a_new_thread(launch):
    """``launch()`` on this thread, then as the first CUDA work of a new
    host thread (as autograd's worker thread runs a backward, and a
    checkpoint's recompute there): the new thread's outputs equal this
    thread's bit for bit.  A launch that encodes tensor maps needs the
    device's context bound on its thread, which a warm launch no longer
    binds through the runtime."""
    want = launch()
    got = {}

    def run():
        try:
            got["out"] = launch()
            torch.cuda.synchronize()
        except Exception as exc:  # noqa: BLE001 - reported below
            got["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert "error" not in got, got.get("error")
    want = want if isinstance(want, tuple) else (want,)
    out = got["out"] if isinstance(got["out"], tuple) else (got["out"],)
    assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_grouped_ffn_bwd_cuda_first_in_a_new_thread(cuda):
    """The backward as the first CUDA work of a host thread (autograd's
    worker thread runs a backward so) after the main thread launched it:
    it launches and gives the main thread's bits (its tensor maps need the
    device's context bound on the thread)."""
    args = _bwd_args(cuda, 37, 64, 64, [10, 0, 12, 15], 3, torch.bfloat16, 5)
    _first_in_a_new_thread(lambda: ffn.grouped_ffn_bwd_cuda(*args))


def test_grouped_ffn_cuda_first_in_a_new_thread(cuda):
    """The BF16 grouped FFN forward (``csrc/grouped_ffn_sm90.cuh``) as a
    new thread's first CUDA work: under ``remat`` a checkpoint reruns it
    in the backward, on autograd's thread."""
    args = _plain_ffn_args(cuda, 37, 64, 64, [10, 0, 12, 15], 3,
                           torch.bfloat16, 6)
    _first_in_a_new_thread(lambda: ffn.grouped_ffn_cuda(*args))


def test_grouped_fp4_ffn_cuda_first_in_a_new_thread(cuda):
    """The W4A4 grouped FFN (``csrc/grouped_fp4_ffn_sm90.cuh``) as a new
    thread's first CUDA work."""
    args = _ffn_args(cuda, 37, 64, 64, [10, 0, 12, 15], torch.bfloat16, 7)
    _first_in_a_new_thread(lambda: ffn.grouped_fp4_ffn_cuda(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp4_matmul_cuda_first_in_a_new_thread(cuda, dtype):
    """``fp4_matmul`` (``csrc/fp4_matmul.cu``, bf16 and f32 x) as a new
    thread's first CUDA work, a4 off and on."""
    args = _mm_args(cuda, 37, 130, 96, dtype, 8)
    for a4 in (False, True):
        _first_in_a_new_thread(lambda: mm.fp4_matmul_cuda(*args, a4=a4))


def test_grouped_ffn_autograd_uses_the_backward_kernel(cuda):
    """``ops.grouped_ffn`` under autograd launches the forward and the
    backward kernel once each, and its gradients are the kernel's; without
    a gradient it is the bare forward launch, bit for bit."""
    xs, gs, wg, wu, wd, dy = _bwd_args(cuda, 300, 256, 192,
                                       [70, 0, 1, 64, 65, 0, 0, 40, 60], 8,
                                       torch.bfloat16, 3)
    w = {"w_gate": wg.clone().requires_grad_(),
         "w_up": wu.clone().requires_grad_(),
         "w_down": wd.clone().requires_grad_()}
    x = xs.clone().requires_grad_()
    ops.reset_launch_counts()
    y = ops.grouped_ffn(x, gs, w)
    y.backward(dy)
    counts = ops.launch_counts()
    assert counts["grouped_ffn"] == 1 and counts["grouped_ffn_bwd"] == 1
    ref = ffn.grouped_ffn_bwd_cuda(xs, gs, wg, wu, wd, dy)
    for got, want in zip((x.grad, w["w_gate"].grad, w["w_up"].grad,
                          w["w_down"].grad), ref):
        assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(ops.grouped_ffn(x, gs, w),
                           ffn.grouped_ffn_cuda(xs, gs, wg, wu, wd))
    assert torch.equal(y.detach(), ffn.grouped_ffn_cuda(xs, gs, wg, wu, wd))


# --------------------------------------------------------------------------
# one train step on the card against the CPU
# --------------------------------------------------------------------------
def train_step_against_cpu(cuda, cfg, rcfg, batch, m):
    """``train_loss`` and its gradient on the card (the forward and
    backward FFN kernels) against the CPU's plain versions on the same f32
    weights (seed 0): the loss and metrics at rtol 1e-4 / atol 3e-5 of
    their size, ``m_state`` and the statistics bit for bit, every gradient
    leaf within the larger of 3e-5 of its max and 4 x the CPU gradient's
    own change when the embedding is scaled by 1 +- 2^-22 (the CPU parity
    tests' criterion: through the whole model the gradient is
    ill-conditioned, ``tests/test_torch_train.py``).  Returns (loss, the
    card's kernel launches, the largest gap over its tolerance)."""
    from repro_torch.optim.grad_utils import value_and_grad
    params = tf.init_model(cfg, seed=0, device="cpu")

    def run(p, dev):
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        (loss, (m2, met)), g = value_and_grad(
            tf.train_loss, common.tree_map(lambda t: t.to(dev), p), cfg,
            rcfg, b, torch.as_tensor(m).to(dev))
        return loss.cpu(), m2.cpu(), {k: v.cpu() for k, v in met.items()}, \
            [t.cpu() for t in common.tree_leaves(g)]

    cpu = run(params, "cpu")
    spread = [run({**params, "embed": params["embed"] * f}, "cpu")[3]
              for f in (1 + 2.0 ** -22, 1 - 2.0 ** -22)]
    ops.reset_launch_counts()
    gpu = run(params, cuda)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    torch.testing.assert_close(gpu[0], cpu[0], rtol=1e-4,
                               atol=3e-5 * float(cpu[0].abs()))
    assert torch.equal(gpu[1], cpu[1])
    for k in ("ce", "lb_loss", "drop_frac"):
        torch.testing.assert_close(gpu[2][k], cpu[2][k], rtol=1e-4,
                                   atol=3e-5 * float(cpu[2][k].abs()))
    for k in ("ib_global", "fp4_ranks", "gate_open", "split_frac"):
        assert torch.equal(gpu[2][k], cpu[2][k]), k
    worst = 0.0
    for i, (a, b) in enumerate(zip(gpu[3], cpu[3])):
        spr = max(float((s[i] - b).abs().max()) for s in spread)
        tol = max(3e-5 * float(b.abs().max()), 4 * spr)
        gap = float((a - b).abs().max())
        assert gap <= tol, (i, gap, tol)
        worst = max(worst, gap / tol if tol else 0.0)
    return float(cpu[0]), counts, worst


def test_train_step_on_the_card_matches_cpu(cuda):
    """Reduced moonshot (f32, ReaLB on over a virtual EP group of 4, FP4
    voted and forced off): the step's loss, statistics and gradients on the
    card match the CPU, through the grouped FFN's forward and backward
    kernels and no FP4 kernel."""
    cfg = reduced(get_config("moonshot-v1-16b-a3b"))
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 512, (4, 16)).astype(np.int32)
    labels[rng.random((4, 16)) < 0.25] = -1
    batch = {"tokens": rng.integers(0, 512, (4, 16)).astype(np.int32),
             "labels": labels, "modality": rng.random((4, 16)) < 0.6}
    rcfg = ReaLBConfig(gate_gamma=8, md_init=0.0, adaptive=False)
    _, counts, _ = train_step_against_cpu(cuda, cfg, rcfg, batch,
                                          np.zeros((1, 4), np.float32))
    assert counts["grouped_ffn"] == counts["grouped_ffn_bwd"] == 3
    assert counts["quantize_fp4"] == counts["grouped_fp4_ffn"] == 0


# --------------------------------------------------------------------------
# Mamba layers and the hybrid MoE (jamba)
# --------------------------------------------------------------------------
def test_reduced_jamba_graphed_decode_equals_eager(cuda):
    """Reduced jamba-1.5-large-398b (attention, Mamba and MoE layers, bf16)
    on the card: one captured decode graph over a prefill's cache serves
    FP4 on and off by the inputs alone; each call equals the eager
    ``decode_forward`` bit for bit (logits, statistics, the cache with the
    Mamba states written in place, ``m_state``), under a strict sentinel;
    the prefill launches the quantizer and the W4A4 FFN."""
    from repro_torch.analysis import Sentinel
    from repro_torch.serving.graphs import StepGraphs
    cfg = reduced(get_config("jamba-1.5-large-398b"), param_dtype="bfloat16")
    params = tf.init_model(cfg, seed=0, device=cuda)
    rcfg = ReaLBConfig(gate_gamma=0, capacity_c=0.0, md_init=0.0,
                       adaptive=False)
    b, s, l = 4, 16, 24
    gen = torch.Generator(device=cuda).manual_seed(3)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device=cuda, dtype=torch.int32)
    m0 = torch.zeros((1, 4), device=cuda)
    ops.reset_launch_counts()
    origin = tf.prefill_forward(params, cfg, rcfg, {
        "tokens": tok, "modality": torch.ones_like(tok, dtype=torch.bool)},
        m0, cache_len=l).cache
    counts = ops.launch_counts()
    assert counts["quantize_fp4"] > 0 and counts["grouped_fp4_ffn"] > 0
    i32 = dict(dtype=torch.int32, device=cuda)
    inputs = {fp4: {"tokens": tok[:, :1].contiguous(),
                    "pos": torch.tensor([s, l, s, s], **i32),
                    "modality": torch.full((b, 1), fp4, device=cuda),
                    "valid": torch.tensor([[True], [False], [True], [True]],
                                          device=cuda)}
              for fp4 in (True, False)}
    state = (common.tree_map(lambda t: t.clone(), origin), m0.clone())
    sent = Sentinel(strict=True)
    sg = StepGraphs(cuda, sentinel=sent)
    for fp4 in (True, False, True):
        fired = graphed_equals_eager(sg, sent, "decode", tf.decode_forward,
                                     params, cfg, rcfg, state, origin, m0,
                                     inputs[fp4], f"decode FP4 {fp4}")
        assert (fired > 0) == fp4
    assert sg.captures["decode"] == 1 and sg.replays["decode"] == 2
    assert sent.violations == []


JAMBA_D, JAMBA_F = 8192, 24576


def test_kernels_at_jamba_expert_shapes(cuda):
    """The quantizer and the global scale bitwise against their plain
    versions on a 2-expert stack at jamba's widths (D = 8192, F = 24576),
    both views; the BF16 and W4A4 grouped FFNs within their checks' bounds
    on ~1024 rows over the two slots plus the pad slot."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    w = {}
    for name, shape in (("w_gate", (2, JAMBA_D, JAMBA_F)),
                        ("w_up", (2, JAMBA_D, JAMBA_F)),
                        ("w_down", (2, JAMBA_F, JAMBA_D))):
        w[name] = torch.empty(shape, dtype=torch.bfloat16, device=cuda)
        for e in range(2):
            w[name][e].copy_(torch.randn(shape[1:], generator=gen,
                                         device=cuda) * 0.02)
    for name in ("w_gate", "w_down"):
        view = w[name].transpose(-1, -2)
        gs = quant.global_scale_for(view)
        assert torch.equal(qk.global_scale_cuda(view).view(torch.int32),
                           gs.view(torch.int32)), name
        pk, sc = qk.quantize_fp4_cuda(view, gs)
        pk_p, sc_p = qk.quantize_fp4_plain(view, gs)
        assert torch.equal(pk, pk_p), name
        assert torch.equal(sc.view(torch.int32), sc_p.view(torch.int32)), name
        del pk, sc, pk_p, sc_p
    gs_list = [500, 524, 256]
    m = sum(gs_list)
    xs = torch.randn(m, JAMBA_D, generator=gen, device=cuda).to(
        torch.bfloat16)
    xs[1024:] = 0
    counts = torch.tensor(gs_list, dtype=torch.int32, device=cuda)
    plain = (xs, counts, w["w_gate"], w["w_up"], w["w_down"])
    y = ffn.grouped_ffn_cuda(*plain)
    check_plain_ffn(y, ffn.grouped_ffn_plain(*plain))
    assert torch.all(y[1024:] == 0)
    wq = [ops.quantize_experts_fp4(w[k].transpose(-1, -2))
          for k in ("w_gate", "w_up", "w_down")]
    args = (xs, counts, *(t for q in wq for t in (q.packed, q.scales)),
            torch.stack([q.global_scale.reshape(()) for q in wq]))
    y = ffn.grouped_fp4_ffn_cuda(*args)
    check_ffn(y, ffn.grouped_fp4_ffn_plain(*args))
    assert torch.all(y[1024:] == 0)


def wide_f32_spread(cuda, n_w):
    """The f32 backward entry at moonshot's width on the numpy inputs of
    ``_torch_bwd_wide`` (the CPU test measures the reference's f32
    ``jax.vjp`` on the same): the largest gap of each output to an f64
    evaluation of the same chain for the kernel and for the plain version
    in f32 (cuBLAS, TF32 off).  Raises unless every output of the kernel
    lies within ``RATIO`` x the plain version's gap and ``RATIO`` x the
    reference's (a plain FMA chain over the depth did not: dx 2.9x the
    plain version's and 5.8x the reference's; the compensated sums of
    ``csrc/grouped_ffn_bwd.cu`` came to 0.24x and 0.47x).  Returns
    {output: (kernel gap, plain gap, reference gap)}."""
    import _torch_bwd_wide as bw
    x, gs, w, dy = bw.inputs(n_w)
    args = [torch.from_numpy(a).to(cuda) for a in (x, gs, *w, dy)]
    got = ffn.grouped_ffn_bwd_cuda(*args)
    plain = ffn.grouped_ffn_bwd_plain(*args)
    f64 = ffn.grouped_ffn_bwd_plain(*(a.double() if a.is_floating_point()
                                      else a for a in args))
    k_gap = bw.gaps([t.cpu() for t in got], [t.cpu() for t in f64])
    p_gap = bw.gaps([t.cpu() for t in plain], [t.cpu() for t in f64])
    out = {n: (k_gap[n], p_gap[n], bw.REF_F64_GAP[n_w][n])
           for n in bw.OUTPUTS}
    bad = [n for n, (k, p, r) in out.items()
           if not (k <= bw.RATIO * p and k <= bw.RATIO * r)]
    if bad:
        raise AssertionError(f"grouped_ffn_bwd f32 Gw={n_w}: the kernel's "
                             f"gap to f64 past {bw.RATIO} x the plain "
                             f"version's or the reference's in {bad}: "
                             f"(kernel, plain, reference) {out}")
    return out


@pytest.mark.parametrize("n_w", (6, 5))
def test_grouped_ffn_bwd_f32_within_the_f32_spread(cuda, n_w):
    """The f32 entry at D = 2048, F = 1408 (448 rows) against an f64
    evaluation: within 2x the plain version's distance and 2x the
    reference's own, output by output (``wide_f32_spread``)."""
    for n, gaps in wide_f32_spread(cuda, n_w).items():
        print(f"Gw={n_w} {n}: kernel, plain, reference gaps to f64 {gaps}")


def test_reduced_minicpm3_graphed_decode_equals_eager(cuda):
    """Reduced minicpm3-4b (MLA, bf16) on the card: one captured decode
    graph over a prefill's latent cache; each call equals the eager
    absorbed ``decode_forward`` bit for bit (logits, statistics, the latent
    and k_rope rows written in place, ``m_state``), under a strict
    sentinel."""
    from repro_torch.analysis import Sentinel
    from repro_torch.serving.graphs import StepGraphs
    cfg = reduced(get_config("minicpm3-4b"), param_dtype="bfloat16")
    params = tf.init_model(cfg, seed=0, device=cuda)
    rcfg = ReaLBConfig()
    b, s, l = 4, 16, 24
    gen = torch.Generator(device=cuda).manual_seed(4)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device=cuda, dtype=torch.int32)
    m0 = torch.zeros((1, 1), device=cuda)
    origin = tf.prefill_forward(params, cfg, rcfg, {"tokens": tok}, m0,
                                cache_len=l).cache
    assert set(origin["blocks"]["layer0"]) == {"latent", "k_rope"}
    i32 = dict(dtype=torch.int32, device=cuda)
    state = (common.tree_map(lambda t: t.clone(), origin), m0.clone())
    sent = Sentinel(strict=True)
    sg = StepGraphs(cuda, sentinel=sent)
    for step in range(3):
        inputs = {"tokens": tok[:, step:step + 1].contiguous(),
                  "pos": torch.tensor([s + step, l, s, s + 2 * step], **i32),
                  "valid": torch.ones((b, 1), dtype=torch.bool,
                                      device=cuda)}
        graphed_equals_eager(sg, sent, "decode", tf.decode_forward, params,
                             cfg, rcfg, state, origin, m0, inputs,
                             f"minicpm3 decode {step}")
    assert sg.captures["decode"] == 1 and sg.replays["decode"] == 2
    assert sent.violations == []


def test_reduced_gemma_graphed_chunk_equals_eager(cuda):
    """Reduced gemma-7b (GeGLU, tied, softcap, sqrt(d) scale, bf16) on the
    card: one captured chunk graph; each call (rows at different starts,
    one idle) equals the eager ``chunk_forward`` bit for bit, under a
    strict sentinel."""
    from repro_torch.analysis import Sentinel
    from repro_torch.serving.graphs import StepGraphs
    cfg = reduced(get_config("gemma-7b"), param_dtype="bfloat16")
    params = tf.init_model(cfg, seed=0, device=cuda)
    rcfg = ReaLBConfig()
    b, s, l = 4, 16, 48
    gen = torch.Generator(device=cuda).manual_seed(5)
    m0 = torch.zeros((1, 1), device=cuda)
    origin = tf.init_cache(cfg, b, l, device=cuda)
    i32 = dict(dtype=torch.int32, device=cuda)
    state = (common.tree_map(lambda t: t.clone(), origin), m0.clone())
    sent = Sentinel(strict=True)
    sg = StepGraphs(cuda, sentinel=sent)
    for start, lens in (([0, 0, 0, 0], [16, 9, 0, 12]),
                        ([16, 9, 0, 12], [16, 3, 5, 0]),
                        ([32, 12, 5, 12], [8, 16, 16, 4])):
        tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                            device=cuda, dtype=torch.int32)
        inputs = {"tokens": tok, "start": torch.tensor(start, **i32),
                  "chunk_len": torch.tensor(lens, **i32)}
        graphed_equals_eager(sg, sent, "chunk", tf.chunk_forward, params,
                             cfg, rcfg, state, origin, m0, inputs,
                             f"gemma chunk {start}")
        origin = common.tree_map(lambda t: t.clone(), state[0])
    assert sg.captures["chunk"] == 1 and sg.replays["chunk"] == 2
    assert sent.violations == []


def _memory_graphed_decode(cuda, arch, memory_rows):
    """Reduced ``arch`` (bf16) on the card: a prefill of 16 tokens on a
    seeded memory (the memory's K/V cached in ``xk``/``xv``), then one
    captured decode graph; each call equals the eager ``decode_forward``
    bit for bit (logits, statistics, the whole cache, ``m_state``), under
    a strict sentinel, and no call writes the memory's K/V."""
    from repro_torch.analysis import Sentinel
    from repro_torch.serving.graphs import StepGraphs
    cfg = reduced(get_config(arch), param_dtype="bfloat16")
    params = tf.init_model(cfg, seed=0, device=cuda)
    rcfg = ReaLBConfig()
    b, s, l = 4, 16, 24
    gen = torch.Generator(device=cuda).manual_seed(6)
    tok = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                        device=cuda, dtype=torch.int32)
    name = "enc_embeds" if cfg.is_encdec else "vision_embeds"
    mem = torch.randn((b, memory_rows, cfg.d_model), generator=gen,
                      device=cuda) * 0.02
    m0 = torch.zeros((1, 1), device=cuda)
    origin = tf.prefill_forward(params, cfg, rcfg, {"tokens": tok, name: mem},
                                m0, cache_len=l).cache
    xk = [c["xk"].clone() for c in origin["blocks"].values() if "xk" in c]
    assert xk and all(t.shape[2] == memory_rows for t in xk)
    i32 = dict(dtype=torch.int32, device=cuda)
    state = (common.tree_map(lambda t: t.clone(), origin), m0.clone())
    sent = Sentinel(strict=True)
    sg = StepGraphs(cuda, sentinel=sent)
    for step in range(3):
        inputs = {"tokens": tok[:, step:step + 1].contiguous(),
                  "pos": torch.tensor([s + step, l, s, s + 2 * step], **i32),
                  "valid": torch.ones((b, 1), dtype=torch.bool,
                                      device=cuda)}
        graphed_equals_eager(sg, sent, "decode", tf.decode_forward, params,
                             cfg, rcfg, state, origin, m0, inputs,
                             f"{arch} decode {step}")
    assert sg.captures["decode"] == 1 and sg.replays["decode"] == 2
    assert sent.violations == []
    got = [c["xk"] for c in state[0]["blocks"].values() if "xk" in c]
    assert all(torch.equal(a, g) for a, g in zip(xk, got))


def test_reduced_vlm_graphed_decode_equals_eager(cuda):
    """Reduced llama-3.2-vision-90b (four self-attention layers and one
    cross layer over 8 vision rows): graphed decode bitwise eager."""
    _memory_graphed_decode(cuda, "llama-3.2-vision-90b", 8)


def test_reduced_whisper_graphed_decode_equals_eager(cuda):
    """Reduced whisper-large-v3 (2 encoder layers over 16 frames; each
    decoder layer self- then cross-attention, QKV bias, GELU): graphed
    decode bitwise eager."""
    _memory_graphed_decode(cuda, "whisper-large-v3", 16)

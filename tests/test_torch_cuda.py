"""The port on a CUDA card: each kernel against its plain version, the
reduced model through the kernels against the same model on the CPU, and
its forwards free of device-to-host syncs.

Every test here needs a card and skips without one.  The file imports no
JAX, so the card's machine runs it as it is:
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py``.
"""
import itertools

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

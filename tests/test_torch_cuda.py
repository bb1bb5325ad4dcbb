"""The port on a CUDA card: each kernel against its plain version, and the
reduced model through the kernels against the same model on the CPU.

Every test here needs a card and skips without one.  The file imports no
JAX, so the card's machine runs it as it is:
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ReaLBConfig, get_config, reduced
from repro_torch.core import quant
from repro_torch.kernels import grouped_fp4_ffn as ffn
from repro_torch.kernels import ops
from repro_torch.kernels import quantize_fp4 as qk
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
    """All-zero tiles (the pad slot's unfilled capacity rows) are skipped
    and stay exactly 0; a tile mixing zero and nonzero rows is computed."""
    gs = [70, 0, 130, 40]
    args = _ffn_args(cuda, 240, 64, 64, gs, dtype, 5)
    xs = args[0]
    xs[70:200] = 0                    # slot 2: two whole zero tiles + part
    xs[210:215] = 0                   # zero rows inside a live tile
    y = ffn.grouped_fp4_ffn_cuda(*args)
    assert torch.all(y[70:200] == 0) and torch.all(y[210:215] == 0)
    check_ffn(y, ffn.grouped_fp4_ffn_plain(*args))


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
    assert cpu[3] == {"quantize_fp4": 0, "grouped_fp4_ffn": 0}
    assert gpu[3]["quantize_fp4"] > 0 and gpu[3]["grouped_fp4_ffn"] > 0
    torch.testing.assert_close(gpu[0], cpu[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gpu[1], cpu[1], rtol=1e-4, atol=1e-4)
    assert torch.equal(gpu[2], cpu[2]) and torch.equal(gpu[4], cpu[4])

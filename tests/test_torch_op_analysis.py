"""The op-level analyzer (``launch.op_analysis``): its counts exactly equal
on the CPU (the kernels' plain versions) and on ``meta`` (their shape
functions) for every architecture and step kind, its GEMM FLOPs against
the reference's HLO analysis, its census against the ledger's
prediction, and its rules (kernels counted once, the larger branch,
views free, storages live until they die)."""
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as RShapeConfig
from repro.configs import get_config as r_get_config
from repro.configs import reduced as r_reduced
from repro.launch import hlo_analysis
from repro.launch import steps as rsteps
from repro_torch.analysis.dispatch_audit import census_matches_prediction
from repro_torch.configs import (ARCH_IDS, ReaLBConfig, ShapeConfig,
                                 TrainConfig, get_config, reduced)
from repro_torch.kernels import cost, ops
from repro_torch.launch import steps
from repro_torch.launch.op_analysis import OpAnalyzer
from repro_torch.models import transformer as tf
from repro_torch.models.common import Mesh
from repro_torch.optim import adamw

ARCH = "moonshot-v1-16b-a3b"
KINDS = {"prefill": (32, 2), "decode": (32, 2), "train": (32, 2)}


def concrete_inputs(cfg, shape, seed=0):
    """The cell's inputs on the CPU, seeded, of ``input_specs``' shapes."""
    spec = steps.input_specs(cfg, shape)
    rng = np.random.default_rng(seed)
    batch = {}
    for k, t in spec["batch"].items():
        if k == "pos":
            batch[k] = torch.full(t.shape, shape.seq_len - 1, dtype=t.dtype)
        elif t.dtype == torch.bool:
            batch[k] = torch.from_numpy(rng.random(t.shape) < 0.4)
        elif t.dtype == torch.int32:
            batch[k] = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, t.shape).astype(np.int32))
        else:
            batch[k] = torch.from_numpy(rng.normal(
                0, 0.02, t.shape).astype(np.float32)).to(t.dtype)
    out = {"params": tf.init_model(cfg, seed=seed, device="cpu"),
           "m_state": torch.zeros(spec["m_state"].shape), "batch": batch}
    if "cache" in spec:
        out["cache"] = tf.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     device="cpu")
    if "opt_state" in spec:
        out["opt_state"] = adamw.init_opt_state(out["params"],
                                                TrainConfig())
    return out


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_counts_equal_on_cpu_and_meta(arch, kind):
    """Flops, traffic, the memory record (peak included), census and the
    kernels' work: the same on the CPU as on ``meta``."""
    cfg = reduced(get_config(arch))
    seq, b = KINDS[kind]
    shape = ShapeConfig(kind, seq, b, kind)
    meta = steps.lower_cell(cfg, shape)
    step, names = steps.build_step(cfg, shape, ReaLBConfig())
    inputs = concrete_inputs(cfg, shape)
    _, an, mem = steps.analyze_step(step, [inputs[n] for n in names])
    assert an.flops == meta["flops_per_device"] > 0
    assert an.traffic == meta["bytes_per_device"] > 0
    assert mem == meta["memory"]
    assert an.census == meta["census"] == {}
    assert an.kernels == meta["kernels"]
    assert an.n_ops == meta["n_ops"]
    if cfg.moe is not None:
        assert meta["kernels"]["grouped_ffn" if kind != "decode"
                               else "grouped_fp4_ffn"]["launches"] > 0


def _reference_flops(kind, seq, b):
    cfg = r_reduced(r_get_config(ARCH))
    lowered = rsteps.lower_cell(cfg, RShapeConfig(kind, seq, b, kind), None)
    return hlo_analysis.analyze(lowered.compile().as_text())["flops"]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_gemm_flops_against_reference(kind):
    """Reduced moonshot without a mesh: the analyzer's GEMM FLOPs against
    ``hlo_analysis.analyze`` of the reference's compiled step.

    Decode: equal.  Prefill and train differ by one term, the expert FFN:
    XLA's CPU backend expands ``jax.lax.ragged_dot`` over every row and
    every one of its G groups (the experts and the pad slot of the
    capacity buffer), 2·M·K·N·G a product, where the kernels work 2·M·K·N
    (each row against its own slot).  The prefill's forward FFN then
    counts G times the port's; in training the reference differentiates
    its three products into six more, all expanded (3·G times the
    forward), where the port's backward kernel works its own eight
    (g, u and dh recomputed, dx twice, three weight gradients: 16·M·D·F,
    ``kernels.cost.grouped_ffn_bwd``).  Held at those values exactly."""
    seq, b = KINDS[kind]
    ref = _reference_flops(kind, seq, b)
    cfg = reduced(get_config(ARCH))
    port = steps.lower_cell(cfg, ShapeConfig(kind, seq, b, kind))
    flops, k = port["flops_per_device"], port["kernels"]
    groups = cfg.moe.num_experts + 1
    if kind == "decode":
        assert abs(flops - ref) <= 0.05 * ref
        assert flops == ref
    elif kind == "prefill":
        fwd = k["grouped_ffn"]["flops"]
        assert k["grouped_fp4_ffn"]["flops"] == fwd     # priced once: max
        assert abs(flops - ref) > 0.05 * ref
        assert ref == flops + (groups - 1) * fwd
    else:
        fwd, bwd = k["grouped_ffn"]["flops"], k["grouped_ffn_bwd"]["flops"]
        assert bwd == fwd * 16 / 6
        assert ref == flops - fwd - bwd + 3 * groups * fwd


@pytest.mark.parametrize("shape,batch", [((2, 4), 4), ((1, 4), 2),
                                         ((2, 4), 3)])
def test_census_equals_prediction_under_abstract_mesh(shape, batch):
    """A prefill of reduced moonshot on ``meta`` under the abstract mesh:
    its ``Comm`` census is ``predict_graph_census`` of its MoE layers (with
    one group a data row when the batch divides, else one replicated
    group)."""
    r = census_matches_prediction(reduced(get_config(ARCH)), batch, 32,
                                  Mesh(shape, "abstract", "meta"))
    assert r["census"] == r["predicted"]
    assert r["census"]["all_to_all"]["count"] == 9


def test_kernel_entry_counted_once_at_its_formula():
    """The quantizer's entry on the CPU: two launches at their formulas,
    none of the plain version's ops, its outputs live after it."""
    w = torch.randn(4, 64, 32)
    with OpAnalyzer() as an:
        q = ops.quantize_experts_fp4(w)
    n = w.numel()
    assert an.n_ops == 0
    assert an.kernels == {
        "global_scale_fp4": {"launches": 1, "flops": 0.0,
                             "bytes": cost.global_scale(n, 4).nbytes},
        "quantize_fp4": {"launches": 1, "flops": 0.0,
                         "bytes": cost.quantizer(n, 4).nbytes}}
    assert an.traffic == (cost.global_scale(n, 4).nbytes
                          + cost.quantizer(n, 4).nbytes)
    assert an.peak == q.packed.nbytes + q.scales.nbytes + 4


def test_branches_priced_at_the_larger():
    a, b = torch.empty(8, 16, device="meta"), torch.empty(16, 4,
                                                          device="meta")
    c = torch.empty(16, 64, device="meta")
    with OpAnalyzer() as an:
        with cost.alternatives():
            with cost.branch("small"):
                a @ b                         # 2·8·16·4
            with cost.branch("large"):
                a @ c                         # 2·8·16·64
            a + 1                             # shared: counted as it comes
        with cost.branch("outside"):
            a @ b                             # no alternatives: counted
    assert an.flops == 2 * 8 * 16 * 64 + 2 * 8 * 16 * 4
    assert an.traffic == (8 * 16 + 16 * 64 + 8 * 64) * 4 \
        + 2 * 8 * 16 * 4 + (8 * 16 + 16 * 4 + 8 * 4) * 4


def test_views_free_and_storages_live_until_they_die():
    with OpAnalyzer() as an:
        x = torch.empty(1024, device="meta")      # 4096 B live, no traffic
        v = x.view(32, 32).t()                    # views: free
        assert an.traffic == 0 and an.live == 4096
        y = x * 2.0                               # 4096 B in, 4096 B out
        assert an.traffic == 8192 and an.live == 8192
        del x
        assert an.live == 8192                    # v holds x's storage
        del v
        assert an.live == 4096
        del y
        assert an.live == 0
    assert an.peak == 8192


def test_no_analyzer_no_work():
    """With no analyzer active the hook calls the entry and nothing
    more."""
    assert cost._analyzer is None
    assert cost.run(lambda: 1 / 0, lambda x: x + 1, 1) == 2
    assert cost.alternatives() is cost._NULL
    assert cost.branch("fp4") is cost._NULL

"""Config dataclasses of the PyTorch port.

A copy of the fields and derived methods of ``repro.configs.base`` that the
serving path and its placement/replication managers read (the port imports nothing from ``repro``).  Configs are
frozen dataclasses, so they hash and compare by value.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts layer config (routed experts)."""

    num_experts: int
    top_k: int
    d_ff: int                      # per-expert ffn hidden size
    n_shared_experts: int = 0      # deepseek-style always-on experts
    capacity_factor: float = 2.0   # dispatch buffer provisioning (× ideal)
    router_dtype: str = "float32"
    moe_every: int = 1             # apply MoE on layers where (i % moe_every == moe_offset)
    moe_offset: int = 0
    aux_loss_coef: float = 0.01    # load-balancing loss (training only)
    router_z_coef: float = 1e-3


@dataclass(frozen=True)
class ModelConfig:
    """One decoder-only attention architecture."""

    name: str
    family: str                 # moe | dense
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                   # dense-ffn hidden size
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None

    layer_pattern: str = "attn"  # the port runs all-attention stacks only
    n_dense_layers: int = 0     # leading layers that use dense FFN even in MoE models

    activation: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    embed_scale_sqrt_d: bool = False   # gemma-style sqrt(d) embedding scale

    param_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.layer_pattern != "attn":
            raise ValueError(f"layer_pattern {self.layer_pattern!r}: the "
                             "port runs all-attention stacks only")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer token-mixer kind for the decoder stack."""
        return ("attn",) * self.n_layers

    def ffn_kinds(self) -> Tuple[str, ...]:
        kinds = []
        for i in range(self.n_layers):
            if self.moe is not None and i >= self.n_dense_layers \
                    and (i - self.n_dense_layers) % self.moe.moe_every == self.moe.moe_offset:
                kinds.append("moe")
            else:
                kinds.append("dense")
        return tuple(kinds)

    @property
    def scan_period(self) -> int:
        """Layers per block of the stacked decoder parameters."""
        return 1

    def moe_block_structure(self) -> Tuple[int, int]:
        """(n_blocks, n_moe_layers_per_block) of the stacked decoder: the
        granularity of per-layer placement/replication tables (one table
        per block)."""
        period = self.scan_period
        rest = self.ffn_kinds()[self.n_dense_layers:]
        assert len(rest) % period == 0, (len(rest), period)
        return len(rest) // period, sum(1 for f in rest[:period]
                                        if f == "moe")


# Nominal expert-slab migration bandwidth (bytes/s): the reference's prior,
# kept so both packages price the same bytes at the same rate until a
# timed apply replaces it.  It is not a rate of any card: the first
# measured gather (repro_torch.placement.migrate.MigrationBandwidth)
# overwrites it.
MIGRATION_BW_DEFAULT = 50e9


@dataclass(frozen=True)
class ReaLBConfig:
    """Paper hyper-parameters (§4.2, §5.1)."""

    enabled: bool = True
    capacity_c: float = 1.0       # hotspot threshold C on IB_d
    tau: float = 1.5              # AIMD congestion threshold on IB_global
    md_init: float = 0.9          # initial modality threshold
    md_add: float = 0.1           # additive increase
    md_mult: float = 0.5          # multiplicative decrease
    md_min: float = 0.0
    gate_gamma: int = 2048        # Γ: global token threshold for LB gate
    adaptive: bool = True         # False -> ReaLB-m* fixed-threshold variants
    overlap: bool = True          # False -> ReaLB-seq
    group_size: int = 16          # NVFP4 quant group
    wq_bits: int = 4


@dataclass(frozen=True)
class PlacementConfig:
    """Predictive expert→rank placement & live migration
    (``repro_torch.placement``).

    The placement loop is the slow-timescale complement to ReaLB: a
    per-layer EWMA predictor of expert loads feeds a planner that remaps
    experts across EP ranks every ``replan_every`` engine iterations;
    ReaLB's FP4 compression absorbs whatever fast-timescale burst the plan
    could not anticipate.
    """

    enabled: bool = True
    planner: str = "least_loaded"  # identity | least_loaded | modality_aware
    replan_every: int = 32         # engine iterations between replans
    warmup_iters: int = 4          # observations required before planning
    ewma_alpha: float = 0.25       # predictor smoothing (1 = last iter only)
    min_gain: float = 0.02         # skip migration below this predicted
    #                                relative reduction of the max rank load
    vis_tol: float = 0.25          # modality_aware: max |r_v| difference for
    #                                a load-balancing swap
    max_swaps: int = 64            # modality_aware: refinement swap budget
    migration_bw: float = MIGRATION_BW_DEFAULT
    #                              # bytes/s charged for moved expert slabs
    #                                in virtual-time serving runs (nominal);
    #                                the prior of the measured-bandwidth EWMA
    per_layer: bool = False        # one table per scanned MoE block instead
    #                                of one shared table; migration becomes
    #                                a layer-diff (changed layers only)
    decode_halflife: float = 0.0   # decode-window EWMA half-life in decode
    #                                iterations (0 = single shared window)
    decode_replan_every: int = 0   # decode iterations between decode-regime
    #                                replans (0 = prefill cadence only)
    max_changed_layers: int = 0    # per-replan churn budget: cap on changed
    #                                layers per per-layer replan, filled in
    #                                predicted-gain order; recovery layers
    #                                are exempt (0 = unlimited)


@dataclass(frozen=True)
class ReplicationConfig:
    """Redundant experts with token-split dispatch (repro_torch.replication).

    The third arm of the comparison: instead of *moving* hot experts
    (placement) or *compressing* them (ReaLB), duplicate them — each rank
    provisions ``spare_per_rank`` extra weight slots beyond its bijective
    ``E // n_ranks`` slab, and an EPLB-style planner fills the spares with
    replicas of the predictor's hottest (vision-weighted) experts.  Routed
    tokens are split deterministically round-robin across an expert's
    replicas, so the post-split physical loads — which the ReaLB policy
    and the capacity packing observe — are flattened.
    """

    enabled: bool = True
    spare_per_rank: int = 1        # replica slots per rank beyond E // R
    max_replicas: int = 2          # replica cap per logical expert (<= ep)
    vis_weight: float = 1.0        # hotness = load + vis_weight * vis
    replan_every: int = 32         # engine iterations between replans
    warmup_iters: int = 4          # observations required before planning
    ewma_alpha: float = 0.25       # predictor smoothing (shared w/ placement)
    min_gain: float = 0.02         # skip re-replication below this predicted
    #                                relative reduction of the max rank load
    migration_bw: float = MIGRATION_BW_DEFAULT
    #                              # bytes/s charged for copied replica slabs
    per_layer: bool = False        # one replica set per scanned MoE block;
    #                                replica adds/drops diff per layer
    decode_halflife: float = 0.0   # decode-window EWMA half-life in decode
    #                                iterations (0 = single shared window)
    decode_replan_every: int = 0   # decode iterations between decode-regime
    #                                replans (0 = prefill cadence only)
    max_changed_layers: int = 0    # per-replan churn budget: cap on changed
    #                                layers per per-layer replan, filled in
    #                                predicted-gain order; recovery layers
    #                                are exempt (0 = unlimited)
    weighted_split: bool = False   # split routed tokens across replicas
    #                                proportionally to host-rank residual
    #                                capacity (deficit round-robin schedule)
    #                                instead of equal-share round-robin


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's recipe)."""
    small = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
        param_dtype="float32",
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff=64,
            capacity_factor=2.0)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)

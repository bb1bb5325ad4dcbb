"""Config dataclasses of the PyTorch port.

A copy of the fields and derived methods of ``repro.configs.base`` that the
serving path, its placement/replication managers and the training path
read (the port imports nothing from ``repro``).  Configs are
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
class MLAConfig:
    """Multi-head latent attention (DeepSeek/MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM config."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclass(frozen=True)
class ModelConfig:
    """One architecture: a decoder of attention, Mamba or the two
    interleaved, with cross-attention layers to a vision memory (a VLM) or
    an encoder in front (encoder-decoder)."""

    name: str
    family: str                 # moe | dense | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                   # dense-ffn hidden size (0 for attn-free)
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # layer pattern: "attn" (all attention), "ssm" (all mamba),
    # "jamba" (1 attn : 7 mamba per 8-block), "cross5" (4 self + 1 cross
    # per 5-block)
    layer_pattern: str = "attn"
    n_dense_layers: int = 0     # leading layers that use dense FFN even in MoE models

    activation: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0
    embed_scale_sqrt_d: bool = False   # gemma-style sqrt(d) embedding scale

    # encoder-decoder (whisper)
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 0        # fixed encoder length (whisper: 1500 frames)

    # vlm: number of vision tokens supplied by the (stubbed) frontend
    n_vision_tokens: int = 0

    param_dtype: str = "bfloat16"
    remat: str = "full"         # none | full | attn_out (training only)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.layer_pattern not in ("attn", "ssm", "jamba", "cross5"):
            raise ValueError(f"layer_pattern {self.layer_pattern!r}")

    @property
    def uses_attention(self) -> bool:
        return self.layer_pattern != "ssm"

    @property
    def full_attention_only(self) -> bool:
        """True if every token-mixing layer is quadratic attention."""
        return self.layer_pattern in ("attn", "cross5") or self.is_encdec

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer token-mixer kind for the decoder stack."""
        if self.layer_pattern == "attn":
            return ("attn",) * self.n_layers
        if self.layer_pattern == "ssm":
            return ("ssm",) * self.n_layers
        if self.layer_pattern == "cross5":
            return tuple("cross" if i % 5 == 4 else "attn"
                         for i in range(self.n_layers))
        return tuple("attn" if i % 8 == 0 else "ssm"
                     for i in range(self.n_layers))

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
        """Layers per block of the stacked decoder parameters (the
        repeating unit of the layer stack)."""
        return {"jamba": 8, "cross5": 5}.get(self.layer_pattern, 1)

    def moe_block_structure(self) -> Tuple[int, int]:
        """(n_blocks, n_moe_layers_per_block) of the stacked decoder: the
        granularity of per-layer placement/replication tables (one table
        per block)."""
        period = self.scan_period
        rest = self.ffn_kinds()[self.n_dense_layers:]
        assert len(rest) % period == 0, (len(rest), period)
        return len(rest) // period, sum(1 for f in rest[:period]
                                        if f == "moe")

    # parameter counting ------------------------------------------------
    def param_count(self) -> int:
        """Total parameters (embedding + decoder [+ encoder])."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self._stack_params(self.layer_kinds(), self.ffn_kinds())
        if self.is_encdec:
            n += self._stack_params(("attn",) * self.n_enc_layers,
                                    ("dense",) * self.n_enc_layers)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared only)."""
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        n += self._stack_params(self.layer_kinds(), self.ffn_kinds(),
                                active=True)
        if self.is_encdec:
            n += self._stack_params(("attn",) * self.n_enc_layers,
                                    ("dense",) * self.n_enc_layers,
                                    active=True)
        return n

    def _stack_params(self, layer_kinds, ffn_kinds,
                      active: bool = False) -> int:
        """The reference's count of a stack's parameters, as it is: a
        ``"cross"`` layer counts a self-attention's projections and a
        second K/V pair, and an encoder-decoder's decoder layers (kind
        "attn") count no cross-attention."""
        d = self.d_model
        total = 0
        for mix, ffn in zip(layer_kinds, ffn_kinds):
            # token mixer
            if mix in ("attn", "cross") and self.mla is not None:
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                total += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                total += m.kv_lora_rank * self.n_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                total += self.n_heads * m.v_head_dim * d
            elif mix in ("attn", "cross"):
                total += d * self.n_heads * self.head_dim          # q
                total += 2 * d * self.n_kv_heads * self.head_dim   # k,v
                total += self.n_heads * self.head_dim * d          # o
            if mix == "cross":  # the reference's extra kv proj
                total += 2 * d * self.n_kv_heads * self.head_dim
            elif mix == "ssm":
                s = self.ssm or SSMConfig()
                d_in = s.expand * d
                dtr = s.resolved_dt_rank(d)
                total += d * 2 * d_in                  # in_proj
                total += d_in * s.d_conv               # conv
                total += d_in * (dtr + 2 * s.d_state)  # x_proj
                total += dtr * d_in + d_in             # dt_proj
                total += d_in * s.d_state + d_in       # A_log, D
                total += d_in * d                      # out_proj
            # ffn
            mult = 3 if self.activation in ("swiglu", "geglu") else 2
            if ffn == "moe":
                e = self.moe
                per = mult * d * e.d_ff
                n_e = (e.top_k if active else e.num_experts)
                total += n_e * per + e.n_shared_experts * per
                total += d * e.num_experts             # router
            else:
                dff = self.d_ff if self.d_ff else (
                    self.moe.d_ff if self.moe else 0)
                if dff:
                    total += mult * d * dff
            total += 2 * d  # two rmsnorm scales
        return total


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


@dataclass(frozen=True)
class TrainConfig:
    """AdamW, its warmup-cosine schedule, clipping and the loop's cadence
    (the reference's ``TrainConfig``)."""

    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    opt_state_dtype: str = "float32"
    grad_accum: int = 1
    grad_compression: bool = False   # int8 all-reduce w/ error feedback
    checkpoint_every: int = 100
    seed: int = 0


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's recipe)."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.layer_pattern == "attn" else 8),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=32,
        enc_seq_len=16 if cfg.is_encdec else 0,
        n_enc_layers=2 if cfg.is_encdec else 0,
        n_vision_tokens=8 if cfg.n_vision_tokens else 0,
        param_dtype="float32",
        remat="none",
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff=64,
            capacity_factor=2.0)
    if cfg.mla is not None:
        small["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                 qk_nope_head_dim=16, qk_rope_head_dim=8,
                                 v_head_dim=16)
    if cfg.ssm is not None:
        small["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2)
    if cfg.layer_pattern == "jamba":
        small["n_layers"] = 8
    if cfg.layer_pattern == "cross5":
        small["n_layers"] = 5
        small["n_vision_tokens"] = 8
    small.update(overrides)
    return dataclasses.replace(cfg, **small)

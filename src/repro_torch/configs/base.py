"""Config dataclasses of the PyTorch port.

A copy of the fields and derived methods of ``repro.configs.base`` that the
serving path reads (the port imports nothing from ``repro``).  Configs are
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

"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf]  72 layers in 9 blocks of 8 (1 attention + 7 mamba);
MoE (16 experts, top-2) on every 2nd layer, dense FFN otherwise.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576, moe_every=2, moe_offset=1, capacity_factor=1.25),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    layer_pattern="jamba",
    activation="swiglu",
)

"""olmoe-1b-7b — 64 experts top-8.  [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,                  # all layers are MoE
    vocab_size=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff=1024, capacity_factor=1.25),
    layer_pattern="attn",
    activation="swiglu",
    qkv_bias=False,
)

"""moonshot-v1-16b-a3b — kimi/moonlight MoE, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  The LLM backbone of the paper's
primary model (Kimi-VL-A3B = MoonViT frontend + this backbone).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=11264,              # dense FFN for the leading dense layer
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408, n_shared_experts=2, capacity_factor=1.25),
    n_dense_layers=1,        # deepseek-v3-style leading dense layer
    layer_pattern="attn",
    activation="swiglu",
    rope_theta=50000.0,
)

"""llama-3.2-vision-90b — cross-attn image layers (4 self : 1 cross per 5).

[hf:meta-llama/Llama-3.2-11B-Vision; unverified]  Vision frontend is a
stub: ``input_specs()`` provides precomputed patch embeddings
``[B, n_vision_tokens, d_model]``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    layer_pattern="cross5",       # every 5th layer cross-attends to vision
    activation="swiglu",
    rope_theta=500000.0,
    n_vision_tokens=1601,         # one 560x560 tile + cls, llama-vision style
)

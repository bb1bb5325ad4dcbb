"""gemma-7b — GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    layer_pattern="attn",
    activation="geglu",
    tie_embeddings=True,
    logit_softcap=30.0,
    embed_scale_sqrt_d=True,
)

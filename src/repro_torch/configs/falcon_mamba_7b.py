"""falcon-mamba-7b — attention-free Mamba-1. [arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,                # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,                   # mamba block subsumes the FFN
    vocab_size=65024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    layer_pattern="ssm",
    tie_embeddings=True,
)

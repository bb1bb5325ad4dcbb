"""whisper-large-v3 — enc-dec, conv frontend stubbed. [arXiv:2212.04356; unverified]

The assigned "32L" is interpreted as the published 32-encoder +
32-decoder-layer stack; the conv/mel frontend is a stub supplying 1500
frame embeddings ``[B, 1500, 1280]``.  Both stacks are built as the
reference builds them: RoPE and RMSNorm (not the published sinusoidal
positions and LayerNorm), bias on Q/K/V only.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,              # decoder layers
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    is_encdec=True,
    enc_seq_len=1500,
    layer_pattern="attn",
    activation="gelu",
    qkv_bias=True,
)

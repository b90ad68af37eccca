"""Zamba2-1.2B hybrid: Mamba2 backbone + ONE shared attention block applied
every 6 layers (weight sharing across applications) [arXiv:2411.15242].

Runs long_500k: decode state is O(1) per Mamba2 layer; the shared-attention
KV caches (6 applications) are head-sharded over the model axis.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_heads=64,  # d_inner=4096, headdim=64 (Mamba2 default)
    ssm_conv=4,
    hybrid_attn_every=6,
)

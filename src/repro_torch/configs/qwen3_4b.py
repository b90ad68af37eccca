"""Qwen3-4B: qk_norm + GQA, d_head=128 (decoupled from d_model/n_heads)
[hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
)

"""Yi-6B: llama-arch GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5e6,
)

"""Minitron-8B (pruned Nemotron-4) [arXiv:2407.14679]. Assignment dims;
the squared-ReLU FFN of Nemotron is mapped to the SwiGLU substrate (noted
in DESIGN.md deviations)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
)

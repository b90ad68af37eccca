"""InternVL2-26B language backbone (InternLM2-20B-chat side) [arXiv:2404.16821].

[vlm]: the InternViT-6B frontend is a STUB per the assignment — input_specs()
provides precomputed patch embeddings (256 visual tokens after pixel
shuffle) injected at the head of the sequence.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1e6,
    n_patches=256,
)

"""Whisper-tiny backbone [arXiv:2212.04356]: 4L enc + 4L dec, d=384, 6H.

Conv frontend STUBBED: input_specs() provides 1500 precomputed frame
embeddings. Assigned 32k decode shapes exceed Whisper's 448-token decoder
context; honored structurally with sinusoidal positions (DESIGN.md note).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_len=1500,
    max_decode_len=448,
)

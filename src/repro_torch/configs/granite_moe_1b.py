"""granite-3.0-1b-a400m-base: 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=32,
    experts_per_token=8,
    d_ff_expert=512,
    tie_embeddings=True,
)

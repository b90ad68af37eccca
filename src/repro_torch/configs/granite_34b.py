"""Granite-34B-Code (llama-arch MQA variant per assignment) [arXiv:2405.04324].

kv=1 (MQA): KV heads cannot shard over a 16-way model axis — the sharding
resolver replicates KV and shards the 48 query heads (see distributed/sharding).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
)

"""DeepSeek-V3 671B [arXiv:2412.19437]: MLA (q_lora 1536 / kv_lora 512 /
nope 128 / rope 64 / v 128), 3 dense layers + 58 MoE layers of 256 routed
experts (top-8, sigmoid aux-loss-free routing) + 1 shared expert, MTP.

The assignment's d_ff=2048 is the *expert* width; dense layers use 18432.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,  # MLA: per-head K/V decompressed from the shared latent
    d_ff=18432,
    vocab_size=129280,
    n_experts=256,
    experts_per_token=8,
    n_shared_experts=1,
    d_ff_expert=2048,
    n_dense_layers=3,
    router_aux_free=True,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    mtp_depth=1,
)

"""xLSTM-125M [arXiv:2405.04517]: mLSTM blocks with sLSTM blocks interleaved
(~7:1 ratio -> positions 5 and 11 of 12). d_ff=0 per assignment: the xLSTM
block's up/down projections subsume the FFN. Runs long_500k (O(1) state)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_expand=2,
    ssm_conv=4,
    slstm_layers=(5, 11),
)

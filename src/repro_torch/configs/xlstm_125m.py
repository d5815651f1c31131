"""xlstm-125m [ssm] — sLSTM + mLSTM blocks.

[arXiv:2405.04517; unverified] 12L d_model=768 4H (kv=4) d_ff=0
vocab=50304. Pure recurrent: O(1) decode state, so long_500k runs.
d_ff=0 per the pool: mixing + channel-mix live inside the xLSTM blocks.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(pattern="msmsmsmsmsms"),
    subquadratic=True,
)

"""xlstm-1.3b [arXiv:2405.04517, unverified]: 48 blocks, d2048 4H,
mLSTM:sLSTM 7:1, no separate FFN (d_ff=0), vocab 50304."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    rope="none", norm="layernorm",
)

"""recurrentgemma-2b [arXiv:2402.19427]: Griffin — RG-LRU + local attention
1:2, 26L d2560 10H (MQA kv=1, head_dim 256) d_ff=7680, vocab 256000,
window 2048.  26 = 8 full (rec,rec,attn) units + 2 remainder rec blocks."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("griffin", "griffin", "local"), local_window=2048,
    rnn_width=2560, activation="geglu", embed_scale=True,
)

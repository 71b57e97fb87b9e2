"""gemma2-27b [arXiv:2408.00118]: 46L d4608 32H (kv=16) d_ff=36864,
vocab 256000, local(4k)/global alternating, attn softcap 50 / final 30,
head_dim 128, query scale (d_model/n_heads)^-0.5."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab_size=256000, head_dim=128,
    block_pattern=("local", "global"), local_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    attn_scale=(4608 / 32) ** -0.5,
    activation="geglu", embed_scale=True,
)

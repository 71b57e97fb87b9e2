"""chatglm3-6b [arXiv:2406.12793]: 28L d4096 32H (kv=2) d_ff=13696,
vocab 65024, 2d (partial, rotary_frac=0.5) RoPE, qkv bias."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    rope="2d", rotary_frac=0.5, qkv_bias=True,
)

"""musicgen-medium [arXiv:2306.05284]: decoder-only over EnCodec tokens,
48L d1536 24H (kv=24) d_ff=6144, vocab 2048.  Audio frontend is a stub
(precomputed EnCodec frame embeddings).  MusicGen uses sinusoidal positions;
we use RoPE, as the JAX package's config does."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    activation="gelu", norm="layernorm",
    frontend="audio", frontend_len=256, frontend_dim=128,
    kv_quant=True,  # 48L x kv=24 cache at 32k
)

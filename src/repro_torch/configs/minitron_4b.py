"""minitron-4b [arXiv:2407.14679]: pruned nemotron, 32L d3072 24H (kv=8)
d_ff=9216, vocab 256000.  Nemotron uses squared-ReLU FFN; we use the
(non-gated) GeLU variant — same matmul structure, as the JAX package does."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=9216, vocab_size=256000,
    activation="gelu", norm="layernorm",
    rope="standard", rope_theta=10000.0, rotary_frac=0.5,
)

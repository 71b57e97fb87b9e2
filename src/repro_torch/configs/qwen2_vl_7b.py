"""qwen2-vl-7b [arXiv:2409.12191]: 28L d3584 28H (kv=4) d_ff=18944,
vocab 152064, M-RoPE (sections 16/24/24 on head_dim 128), vision frontend
stub (precomputed ViT patch embeddings via input_specs)."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    rope="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    qkv_bias=True,
    frontend="vision", frontend_len=256, frontend_dim=1280,
)

"""deepseek-7b [arXiv:2401.02954]: llama-arch, 30L d4096 32H (kv=32 MHA)
d_ff=11008, vocab 102400."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=102400,
    kv_quant=True,  # MHA (kv=32): int8 keys and values, half a bf16 cache
)

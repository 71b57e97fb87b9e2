"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]: 32L d4096 32H
(kv=8) expert d_ff=6400, vocab 32064, 16 experts top-2."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=0, vocab_size=32064,
    n_experts=16, moe_top_k=2, expert_d_ff=6400, n_shared_experts=0,
    rope="standard", rope_theta=10000.0,
)

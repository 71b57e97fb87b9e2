"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 24L d2048 16H (kv=16)
routed d_ff=1408, vocab 151936, MoE 60 routed top-4 + 4 shared."""
from ..models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=0, vocab_size=151936,
    n_experts=60, moe_top_k=4, expert_d_ff=1408, n_shared_experts=4,
    moe_norm_topk=True, qkv_bias=True,
    rope="standard", rope_theta=1e6,
    kv_quant=True,  # 24L x kv=16 cache at 32k decode
)

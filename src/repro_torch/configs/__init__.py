"""Config registry (the JAX package's ``repro.configs``): the 10 LM
architectures, at their published widths, and the paper's own DCNN
configs, selectable by name.  Pure data: nothing here downloads or
allocates.  The port serves and trains all ten LMs on one device;
phi3.5-moe's 83.5 GB of bf16 weights wait at full width for expert
sharding over four cards (ROADMAP.md A16, item 4)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from ..models.dcnn import CELEBA_DCNN, MNIST_DCNN, DcnnConfig
from ..models.transformer import ModelConfig
from . import (
    chatglm3_6b,
    deepseek_7b,
    gemma2_27b,
    minitron_4b,
    musicgen_medium,
    phi35_moe_42b,
    qwen2_moe_a2p7b,
    qwen2_vl_7b,
    recurrentgemma_2b,
    xlstm_1p3b,
)
from .shapes import SHAPES, ShapeSuite, input_specs, shape_applicable

LM_CONFIGS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        qwen2_moe_a2p7b.CONFIG,
        phi35_moe_42b.CONFIG,
        minitron_4b.CONFIG,
        chatglm3_6b.CONFIG,
        deepseek_7b.CONFIG,
        gemma2_27b.CONFIG,
        qwen2_vl_7b.CONFIG,
        musicgen_medium.CONFIG,
        recurrentgemma_2b.CONFIG,
        xlstm_1p3b.CONFIG,
    ]
}

DCNN_CONFIGS: Dict[str, DcnnConfig] = {
    "dcnn-mnist": MNIST_DCNN,
    "dcnn-celeba": CELEBA_DCNN,
}

__all__ = ["DCNN_CONFIGS", "LM_CONFIGS", "SHAPES", "ShapeSuite",
           "get_config", "input_specs", "list_configs", "reduced_config",
           "shape_applicable"]


def get_config(name: str):
    if name in LM_CONFIGS:
        return LM_CONFIGS[name]
    if name in DCNN_CONFIGS:
        return DCNN_CONFIGS[name]
    raise KeyError(
        f"unknown arch {name!r}; available: {sorted(LM_CONFIGS) + sorted(DCNN_CONFIGS)}"
    )


def list_configs() -> List[str]:
    return sorted(LM_CONFIGS) + sorted(DCNN_CONFIGS)


def reduced_config(name: str) -> ModelConfig:
    """Family-faithful reduced config for CPU smoke tests: same block
    pattern/features, tiny dims."""
    cfg = LM_CONFIGS[name]
    pattern = cfg.block_pattern
    n_layers = max(len(pattern), 2) if len(pattern) > 1 else 2
    if cfg.name == "recurrentgemma-2b":
        n_layers = 5  # keep the remainder-unit path covered (3 + 2)
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        n_experts=8 if cfg.n_experts else 0,
        expert_d_ff=32 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 2),
        local_window=16,
        rnn_width=64 if cfg.rnn_width else 0,
        frontend_len=8 if cfg.frontend else 0,
        frontend_dim=24 if cfg.frontend else 0,
        mrope_sections=(4, 2, 2) if cfg.mrope_sections else None,
        attn_scale=None,
        dtype="float32",
        attn_block_q=16,
        attn_block_k=16,
        remat=False,
    )

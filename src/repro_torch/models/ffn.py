"""Dense gated FFNs (the JAX package's ``repro.models.ffn``, its dense
half): SwiGLU, GeGLU and the plain GeLU MLP.  The top-k routed
Mixture-of-Experts (``moe_init``/``moe_apply``) has not been ported yet
(ROADMAP.md A16); `models.transformer` refuses a MoE block."""
from __future__ import annotations

from typing import Optional

import torch

from . import nn


def ffn_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             dtype: torch.dtype, activation: str = "swiglu",
             device=None) -> nn.Params:
    p = {"wu": nn.dense_init(generator, d_model, d_ff, dtype, device=device),
         "wd": nn.dense_init(generator, d_ff, d_model, dtype, device=device)}
    if activation in ("swiglu", "geglu"):
        p["wg"] = nn.dense_init(generator, d_model, d_ff, dtype,
                                device=device)
    return p


def ffn_apply(p: nn.Params, x: torch.Tensor,
              activation: str = "swiglu") -> torch.Tensor:
    if activation == "swiglu":
        h = nn.silu(nn.dense(p["wg"], x)) * nn.dense(p["wu"], x)
    elif activation == "geglu":
        h = nn.gelu(nn.dense(p["wg"], x)) * nn.dense(p["wu"], x)
    else:  # gelu
        h = nn.gelu(nn.dense(p["wu"], x))
    return nn.dense(p["wd"], h)

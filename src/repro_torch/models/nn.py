"""The parts of the JAX package's functional NN substrate
(``repro.models.nn``) that the WGAN critic needs: LeCun-normal init and a
dense layer.  Params are dicts of tensors; the reference's logical-axis
specs wait for the multi-device port."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch


def lecun_init(generator: torch.Generator, shape, dtype: torch.dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """N(0, 1/fan_in) weights (fan_in defaults to ``shape[0]``) drawn from
    ``generator`` on the CPU, so a seed gives the same weights whatever
    device they go to."""
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan, 1))
    return (scale * torch.randn(shape, generator=generator)).to(dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, bias: bool = False,
               device="cpu") -> Dict[str, torch.Tensor]:
    p = {"w": lecun_init(generator, (d_in, d_out), dtype).to(device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y

"""Oracles for the deconv2d kernels: the conventional zero-insertion
transposed convolution (``F.conv_transpose2d``), an implementation entirely
independent of the reverse-loop/phase machinery under test.  The int8
oracle runs it in float64, exact for int8 products below 2**53, and
applies the same requant epilogue as the kernel."""
from __future__ import annotations

from typing import Optional

import torch

from ...core.deconv import deconv2d_zero_insertion


def deconv2d_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int,
    padding: int,
) -> torch.Tensor:
    """x: (N, IH, IW, CI); w: (K, K, CI, CO); y: (N, OH, OW, CO)."""
    return deconv2d_zero_insertion(x, w, b, stride, padding)


def deconv2d_int8_ref(
    x_q: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int,
    padding: int,
    activation: Optional[str] = None,
    out_scale: Optional[float] = None,
) -> torch.Tensor:
    """Integer-exact oracle of `deconv2d_int8`: x_q (N, IH, IW, CI) int8,
    w_q (K, K, CI, CO) int8, scale (CO,) f32, b (CO,) f32 or None."""
    from .int8 import requant_epilogue

    acc = deconv2d_zero_insertion(x_q.double(), w_q.double(), None, stride,
                                  padding).to(torch.int32)
    bias = (b.float() if b is not None
            else torch.zeros((w_q.shape[3],), device=x_q.device))
    return requant_epilogue(acc, scale, bias, activation, out_scale)

"""Symmetric int8 quantization math.

Symmetric, zero-point-free: q = clip(round(x / s), -127, 127), x' = q * s.
Zero maps to zero exactly, so the deconv kernels pad quantized tensors
(halo rows, ragged tiles) with plain zeros.

The arithmetic is the JAX package's ``repro.quant.qmath``: a true division
``x / scale`` (not a multiply by the reciprocal), round half to even
(``torch.round``, like ``jnp.round``) and a clip to +-127.  A Python-float
scale is rounded to float32 before the division, as ``jnp`` does with a
weakly typed scalar, and it is divided as a tensor on ``x``'s device: CUDA
torch divides by a CPU scalar through its reciprocal, which can differ from
the quotient in the last bit.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

QMAX = 127          # int8 symmetric range [-127, 127] (-128 unused)
_EPS = 1e-12        # keeps all-zero tensors from dividing by zero

Scale = Union[float, np.ndarray, torch.Tensor]


def symmetric_scale(amax, qmax: int = QMAX):
    """Scale mapping the clip value ``amax`` onto the integer range."""
    return amax / qmax + _EPS


def scale_tensor(scale: Scale, device) -> torch.Tensor:
    """``scale`` as a float32 tensor on ``device`` (a Python float is
    rounded to float32 once, here)."""
    if isinstance(scale, torch.Tensor):
        return scale.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(scale, np.float32), device=device)


def quantize_symmetric(x: torch.Tensor, scale: Scale,
                       qmax: int = QMAX) -> torch.Tensor:
    """Round-to-nearest-even symmetric quantization, saturating at +-qmax."""
    q = torch.round(x.float() / scale_tensor(scale, x.device))
    return torch.clamp(q, -qmax, qmax).to(torch.int8)


def dequantize_symmetric(q: torch.Tensor, scale: Scale) -> torch.Tensor:
    return q.float() * scale_tensor(scale, q.device)


def fake_quant(x: torch.Tensor, scale: Scale, qmax: int = QMAX) -> torch.Tensor:
    """Quantize-dequantize in f32 (same rounding, same saturation)."""
    return dequantize_symmetric(quantize_symmetric(x, scale, qmax), scale)

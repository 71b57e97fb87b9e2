"""fp32 oracle for the deconv2d kernel: the conventional zero-insertion
transposed convolution (``F.conv_transpose2d``), an implementation entirely
independent of the reverse-loop/phase machinery under test."""
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

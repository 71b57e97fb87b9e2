"""Gradient compression (the JAX package's ``repro.optim.compression``):
symmetric int8 quantization with one scale per leaf, plus error feedback
(the residual carried to the next step).  In the reference it sits where
a data-parallel all-reduce would, cutting its bytes about 4x; on one
device it changes the step's arithmetic exactly as it would there.

The scale/round/clip arithmetic is `quant.qmath`, the inference path's
int8 math.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..core.tree import tree_leaves, tree_map
from ..quant.qmath import dequantize_symmetric, quantize_absmax


class EFState(NamedTuple):
    residual: Any


def init_error_feedback(grads_like) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def quantize_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return quantize_absmax(g)


def dequantize_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return dequantize_symmetric(q, scale)


def compress_grads(grads, ef: EFState) -> Tuple[Any, Any, EFState]:
    """Returns (quantized tree, scales tree, new error-feedback state)."""
    corrected = tree_map(lambda g, r: g.float() + r, grads, ef.residual)
    qs = [quantize_leaf(c) for c in tree_leaves(corrected)]
    it_q, it_s = iter([q for q, _ in qs]), iter([s for _, s in qs])
    q = tree_map(lambda _: next(it_q), corrected)
    s = tree_map(lambda _: next(it_s), corrected)
    deq = tree_map(dequantize_leaf, q, s)
    new_res = tree_map(lambda c, d: c - d, corrected, deq)
    return q, s, EFState(residual=new_res)


def decompress_grads(q, s):
    return tree_map(dequantize_leaf, q, s)


def compression_ratio(grads) -> float:
    raw = sum(g.numel() * 4 for g in tree_leaves(grads))
    comp = sum(g.numel() * 1 + 4 for g in tree_leaves(grads))
    return raw / comp

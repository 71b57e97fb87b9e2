"""The input-shape suites of the JAX package's ``repro.configs.shapes``,
with tensors on the "meta" device in place of ``jax.ShapeDtypeStruct``.

Every LM arch is paired with 4 shapes:
  train_4k    : seq 4096,   global_batch 256  -> a training step
  prefill_32k : seq 32768,  global_batch 32   -> serve prefill
  decode_32k  : cache 32768, global_batch 128 -> serve decode (1 new token)
  long_500k   : cache 524288, global_batch 1  -> serve decode; needs
                sub-quadratic attention (full-attention archs skip it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ..models.transformer import ModelConfig, init_cache


@dataclasses.dataclass(frozen=True)
class ShapeSuite:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSuite] = {
    "train_4k": ShapeSuite("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSuite("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSuite("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSuite("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSuite) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reason for the skip."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return ("full-attention arch: O(L^2) at 524k; sub-quadratic archs "
                "only")
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSuite) -> Dict[str, object]:
    """Stand-ins for every model input of this cell: tensors of the right
    shape and dtype on the "meta" device (no memory allocated)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    if shape.kind in ("train", "prefill"):
        s_tok = s - cfg.frontend_len if cfg.frontend else s
        specs: Dict[str, object] = {"tokens": _meta((b, s_tok), i32)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, s_tok), i32)
        if cfg.frontend:
            specs["frontend_embeds"] = _meta(
                (b, cfg.frontend_len, cfg.frontend_dim), cfg.tdtype)
        return specs

    # decode: one new token against a cache of seq_len
    return {"tokens": _meta((b, 1), i32),
            "cache": init_cache(cfg, b, s, device="meta")}

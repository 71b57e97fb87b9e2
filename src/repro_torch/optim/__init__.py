"""Functional optimizers, learning-rate schedules and int8 gradient
compression with error feedback (no ``torch.optim``)."""
from .compression import (EFState, compress_grads, compression_ratio,
                          decompress_grads, init_error_feedback)
from .optimizer import SGD, AdamState, AdamW, global_norm
from .schedule import constant, warmup_cosine

__all__ = ["AdamState", "AdamW", "EFState", "SGD", "compress_grads",
           "compression_ratio", "constant", "decompress_grads",
           "global_norm", "init_error_feedback", "warmup_cosine"]

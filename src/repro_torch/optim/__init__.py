"""Functional optimizers and learning-rate schedules (no ``torch.optim``).
``optim/compression.py`` of the JAX package waits for the multi-device
port: its only users are the sharded LM paths."""
from .optimizer import SGD, AdamState, AdamW, global_norm
from .schedule import constant, warmup_cosine

__all__ = ["AdamState", "AdamW", "SGD", "constant", "global_norm",
           "warmup_cosine"]
